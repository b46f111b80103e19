"""The work counts against values worked by hand at one small shape."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.count import kernels, peaks, work
from port_bench.reference import model as R
from port_bench.tests import smoke


def test_kernel_work_by_hand():
    # GroupNorm of [2, 4, 3, 3] in bf16: x read, y written, scale and bias read
    assert kernels.work("group_norm", {"numel": 72, "channels": 4}, 2) == {
        "flops": 0.0, "exps": 0.0, "bytes": (72 + 72 + 4 + 4) * 2}
    # attention, b=2, 3 heads of d=4, n=m=5: 4*2*3*5*5*4 FLOPs, 2*3*5*5 exps,
    # q, k, v, o of 2*5*12 values each
    shape = {"b": 2, "heads": 3, "n": 5, "m": 5, "d": 4}
    assert kernels.work("attention", shape, 2) == {
        "flops": 2400.0, "exps": 150.0, "bytes": 4 * 120 * 2}
    # its backward: twice the FLOPs, no exps; q, k, v, o, do read, dq, dk, dv written
    assert kernels.work("attention_bwd", shape, 2) == {
        "flops": 4800.0, "exps": 0.0, "bytes": 8 * 120 * 2}
    # GEGLU MLP, 6 rows, C=4, F=16: 6*6*4*16 FLOPs; x and out 6*4 each, W1 4x32,
    # W2 16x4, b1 32, LayerNorm scale and shift and b2 4 each
    assert kernels.work("geglu", {"rows": 6, "c": 4, "f": 16}, 2) == {
        "flops": 2304.0, "exps": 0.0, "bytes": (48 + 192 + 32 + 12) * 2}


def test_bound_is_the_slowest_resource():
    h = peaks.H100
    assert peaks.bound_s(flops=989e12) == 1.0
    assert peaks.bound_s(nbytes=3.35e12) == 1.0
    assert abs(peaks.bound_s(exps=h["exp_per_s"]) - 1.0) < 1e-12
    assert peaks.bound_s(flops=989e9, nbytes=3.35e12) == 1.0
    calls = [("group_norm", {"numel": 1000, "channels": 10})] * 3
    got = kernels.bound_seconds(calls, 2)["group_norm"]
    assert abs(got - 3 * (2020 * 2) / 3.35e12) < 1e-20  # x read, y written, 20 affine


def test_flop_counter_on_a_conv_by_hand():
    with torch.device("meta"):
        conv = R.conv(4, 6, 3)
        x = torch.empty(2, 4, 5, 5)
    with FlopCounterMode(display=False) as fc:
        conv(x)
    assert fc.get_total_flops() == 2 * 2 * 6 * 5 * 5 * 4 * 9


def test_chunk_and_step_counts():
    cfg = smoke.config(attention="spatial")
    chunk = work.sample_chunk(cfg, rows=4, steps=5)
    assert chunk["flops"] == 5 * chunk["unet_flops"] + chunk["decode_flops"] > 0
    kinds = [k for k, _ in chunk["calls"]]
    per_forward = kinds.count("attention") // 5
    # a SpatialTransformer at every stage above the first level and in the middle:
    # encoder 2 + 2, middle 1, decoder 3 + 3
    assert per_forward == 11
    assert kinds.count("geglu") == 5 * 11
    step = work.train_step(cfg, rows=4)
    skinds = [k for k, _ in step["calls"]]
    assert skinds.count("attention") == skinds.count("attention_bwd") == 11
    # forward + backward of the UNet is about three forwards, plus the encode
    assert 2.5 * chunk["unet_flops"] < step["flops"]
    none = work.train_step(smoke.config(attention="none"), rows=4)
    assert not any(k in ("attention", "geglu") for k, _ in none["calls"])
