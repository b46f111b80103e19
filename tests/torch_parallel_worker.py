"""One rank of the port's multi-process tests on the CPU (gloo).

``python -m tests.torch_parallel_worker <suite> <rank> <world> <port> <dir>``
runs every case of ``suite`` for the world size at ``rank``, reading the
parent's inputs from ``<dir>/inputs.pt`` and writing each case's results
(or its traceback) to ``<dir>/<case>_<world>_<rank>.pt``. It imports torch and the
port only: the parent computes the JAX references. ``spawn`` starts the
ranks from a test and waits for them with a time limit that kills them;
``write_inputs`` hands them their inputs, which they wait for, so that
their start-up overlaps the parent's work.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# the small UNet of tests/test_parallel.py::_setup, with time and label embedders
UNET_KW = dict(in_ch=1, out_ch=1, hid_chs=(8, 16), kernel_sizes=(3, 3), strides=(1, 2),
               norm_name=("GROUP", {"num_groups": 4, "affine": True}),
               deep_supervision=0, use_attention="none", time_emb_dim=16,
               cond_emb_num_classes=2)
UNET_SPATIAL_KW = dict(UNET_KW, hid_chs=(16, 16), use_attention="spatial")
DIT_KW = dict(in_ch=2, patch_size=2, hidden_size=32, depth=2, num_heads=2,
              cond_emb_num_classes=2, moe_experts=4, moe_every=1, moe_num_selected=2)
MOE_KW = dict(hidden_size=16, mlp_dim=32, num_experts=8, num_selected=2,
              capacity_factor=4.0)
T = 10  # the pipeline's schedule (linear)
LR = 1e-3
ADAMW_DECAY = 1e-4  # optax.adamw's default
SAMPLE_N, SAMPLE_SHAPE = 16, (8, 8, 1)


def spawn(suite: str, world: int, tmp: Path, timeout: float = 150.0):
    """Start ``world`` ranks of ``suite``; returns a function that waits
    for them (killing all at ``timeout`` seconds) and returns each rank's
    output."""
    from medfusion_tpu_torch.parallel.multihost import free_port

    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    logs = [open(tmp / f"{suite}_{world}_{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", suite,
                               str(r), str(world), str(port), str(tmp)],
                              cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    state = {}

    def wait():
        if "out" in state:
            return state["out"]
        deadline = time.monotonic() + timeout
        hung = False
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                hung = True
        if hung:
            for p in procs:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        state["out"] = (hung, [p.returncode for p in procs], outs)
        return state["out"]

    return wait


def write_inputs(tmp: Path, inputs) -> None:
    """Write the ranks' inputs, whole or not at all (a rename)."""
    torch.save(inputs, tmp / "inputs.tmp")
    os.replace(tmp / "inputs.tmp", tmp / "inputs.pt")


def _read_inputs(tmp: Path, timeout: float = 120.0):
    deadline = time.monotonic() + timeout
    while not (tmp / "inputs.pt").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs in {tmp} after {timeout} s")
        time.sleep(0.05)
    return torch.load(tmp / "inputs.pt", weights_only=False)


def load_results(tmp: Path, case: str, world: int, wait):
    """Every rank's results of ``case``; raises with the ranks' output when
    a rank hung, failed to start, or raised in the case."""
    hung, codes, outs = wait()
    res = []
    for r in range(world):
        f = tmp / f"{case}_{world}_{r}.pt"
        if not f.exists():
            raise AssertionError(f"{case}: no result from rank {r} (hung={hung}, exit codes "
                                 f"{codes}):\n" + "\n".join(o[-3000:] for o in outs))
        out = torch.load(f, weights_only=False)
        if "error" in out:
            raise AssertionError(f"{case} failed on rank {r}:\n{out['error']}")
        res.append(out)
    return res


@contextlib.contextmanager
def one_rank_group():
    """A gloo group of this process alone, destroyed on exit (for tests in
    the pytest process that need a group of one)."""
    import torch.distributed as dist

    from medfusion_tpu_torch.parallel.multihost import initialize_multihost

    assert not dist.is_initialized()
    initialize_multihost(device="cpu")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# ---- helpers the cases share ------------------------------------------------------


def _unet(kw, sd):
    from medfusion_tpu_torch.models.unet import UNet

    m = UNet(**kw)
    m.load_state_dict(sd, strict=True)
    return m


def _pipeline(unet):
    from medfusion_tpu_torch.core.schedules import GaussianDiffusionSchedule
    from medfusion_tpu_torch.pipelines.diffusion import DiffusionPipeline

    sched = GaussianDiffusionSchedule.create(timesteps=T, schedule_strategy="linear")
    return DiffusionPipeline(scheduler=sched, noise_estimator=unet, do_input_centering=False)


def _whole_params(model):
    from medfusion_tpu_torch.parallel.mesh import layout, whole

    lay = layout(model)
    return {k: (whole(lay[k], p.detach()) if k in lay else p.detach()).clone()
            for k, p in model.named_parameters()}


def _specs(specs):
    """Placements as plain tuples: ('R',) or ('S', dim) a mesh dim."""
    from medfusion_tpu_torch.parallel.mesh import Shard

    return {k: tuple(("S", p.dim) if isinstance(p, Shard) else ("R",) for p in v)
            for k, v in specs.items()}


def _train_step(inp, mesh, **placement):
    from medfusion_tpu_torch.parallel import shard_batch, shard_params
    from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step

    model = _unet(UNET_KW, inp["unet"])
    shard_params(model, mesh, **placement)
    state = TrainState(model, lr=LR, weight_decay=ADAMW_DECAY)
    step = make_diffusion_train_step(_pipeline(model))
    metrics = step(state, shard_batch(inp["batch"], mesh), shard_batch(inp["draws"], mesh))
    return {"loss": metrics["loss"], "params": _whole_params(model)}


# ---- suite: parallel ---------------------------------------------------------------


def case_train_dp(inp, world):
    from medfusion_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    return _train_step(inp, mesh)


def case_sync_counters(inp, world):
    """The dp step with the spans recorded: ``parallel.sync_gradients``'s
    counters and the bytes of the model's f32 gradients."""
    from medfusion_tpu_torch.parallel import make_mesh
    from medfusion_tpu_torch.utils import profiling

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    with profiling.recording() as rec:
        _train_step(inp, mesh)
    model = _unet(UNET_KW, inp["unet"])
    return {"spans": [(s.name, s.parent, s.round, dict(s.counters)) for s in rec.spans],
            "grad_bytes": sum(p.numel() * 4 for p in model.parameters())}


def case_train_fsdp(inp, world):
    from medfusion_tpu_torch.parallel import fsdp_partition_spec, make_mesh

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    specs = _specs(fsdp_partition_spec(_unet(UNET_KW, inp["unet"]), mesh, min_size=16))
    out = _train_step(inp, mesh, fsdp=True, fsdp_min_size=16)
    return {**out, "specs": specs}


def case_train_fsdp_tp(inp, world):
    from medfusion_tpu_torch.parallel import (
        fsdp_partition_spec,
        make_mesh,
        model_partition_spec,
        shard_batch,
        shard_params,
    )

    mesh = make_mesh(n_data=world // 2, n_model=2, device="cpu")
    ref = _unet(UNET_KW, inp["unet"])
    tp = model_partition_spec(ref, mesh, min_shard_dim=16)
    both = fsdp_partition_spec(ref, mesh, min_size=16, tp_specs=tp)
    out = _train_step(inp, mesh, tensor_parallel=True, fsdp=True, min_shard_dim=16,
                      fsdp_min_size=16)
    # the tensor-parallel forward alone, on this rank's rows
    model = shard_params(_unet(UNET_KW, inp["unet"]), mesh, tensor_parallel=True,
                         min_shard_dim=16)
    x = shard_batch(inp["batch"]["source"], mesh).movedim(-1, 1)
    with torch.no_grad():
        y, _ = model(x, torch.zeros((x.shape[0],), dtype=torch.long))
    return {**out, "tp_specs": _specs(tp), "specs": _specs(both), "tp_forward": y}


def case_tp_spatial(inp, world):
    """The tensor-parallel forward of the spatial-attention UNet: its
    attention projections compute sliced, its fused GEGLU MLP gathers its
    sliced weights."""
    from medfusion_tpu_torch.parallel import make_mesh, shard_params

    mesh = make_mesh(n_data=1, n_model=world, device="cpu")
    model = shard_params(_unet(UNET_SPATIAL_KW, inp["unet_spatial"]), mesh,
                         tensor_parallel=True, min_shard_dim=16)
    sharded = sorted(k for k, p in model.named_parameters()
                     if model.parallel_plan.tp_dim(k) is not None)
    x = inp["batch"]["source"].movedim(-1, 1)
    t = inp["draws"]["t"]
    with torch.no_grad():
        y, _ = model(x, t, inp["batch"]["target"])
    return {"y": y, "sharded": sharded}


def case_dit_specs(inp, world):
    from medfusion_tpu_torch.models.dit import DiT
    from medfusion_tpu_torch.parallel import (
        fsdp_partition_spec,
        make_mesh,
        model_partition_spec,
        moe_partition_spec,
    )

    dit = DiT(**DIT_KW)
    out = {}
    for n_data, n_model in ((world, 1), (1, world)):
        mesh = make_mesh(n_data=n_data, n_model=n_model, device="cpu")
        out[(n_data, n_model)] = {
            "tp": _specs(model_partition_spec(dit, mesh, min_shard_dim=16)),
            "fsdp": _specs(fsdp_partition_spec(dit, mesh, min_size=16)),
            "moe": {i: _specs(moe_partition_spec(b.moe_mlp, mesh))
                    for i, b in enumerate(dit.blocks) if b.moe_mlp is not None}}
    return out


def case_sampler(inp, world):
    from medfusion_tpu_torch.parallel import make_mesh, make_sharded_sampler
    from medfusion_tpu_torch.pipelines.flow import FlowMatchingPipeline

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    unet = _unet(UNET_KW, inp["unet"]).eval()
    pipe = _pipeline(unet)
    flow = FlowMatchingPipeline(noise_estimator=unet)
    out = {}
    for name, kw in inp["sampler_cases"].items():
        kw = dict(kw)
        noise = kw.pop("noise", None)
        x_T = kw.pop("x_T")
        gs = kw.pop("guidance_scale")
        fn = make_sharded_sampler(flow if kw.get("sampler") == "flow" else pipe, mesh,
                                  SAMPLE_SHAPE, guidance_scale=gs, decode=False, **kw)
        out[name] = fn(None, SAMPLE_N, inp["cond"], inp["un_cond"], x_T=x_T, noise=noise)
    # the generator's draws: world N's rows of world 1's chunk
    fn = make_sharded_sampler(pipe, mesh, SAMPLE_SHAPE, steps=4, guidance_scale=2.0,
                              decode=False)
    gen = torch.Generator().manual_seed(5)
    out["generator"] = fn(gen, SAMPLE_N, inp["cond"], inp["un_cond"])
    out["no_condition"] = fn(torch.Generator().manual_seed(5), SAMPLE_N)
    return out


def case_ring_attention(inp, world):
    from medfusion_tpu_torch.parallel import make_mesh, ring_attention
    from medfusion_tpu_torch.parallel.ring_attention import shard_tokens

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    q, k, v = (shard_tokens(t, mesh) for t in inp["qkv"])
    with torch.no_grad():
        return {"out": ring_attention(q, k, v, mesh, scale=inp["qkv_scale"], axis="data")}


def case_ring_attention_grad(inp, world):
    """This rank's dq, dk, dv of sum(o * w), for the parent's w and for w
    with rank 0's rows zero (rank 0's dO all zero: it must still run the
    backward, which sends and receives)."""
    from medfusion_tpu_torch.parallel import make_mesh, ring_attention
    from medfusion_tpu_torch.parallel.ring_attention import shard_tokens

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    q, k, v = (shard_tokens(t, mesh).requires_grad_(True) for t in inp["qkv"])
    w = shard_tokens(inp["ring_w"], mesh)
    o = ring_attention(q, k, v, mesh, scale=inp["qkv_scale"], axis="data")
    out = {}
    for name, cot in (("random", w), ("zero_on_rank_0", w * (mesh.get_local_rank("data") != 0))):
        grads = torch.autograd.grad((o * cot).sum(), (q, k, v), retain_graph=True)
        out[name] = dict(zip(("dq", "dk", "dv"), grads))
    return out


def case_moe(inp, world):
    from medfusion_tpu_torch.parallel import make_mesh
    from medfusion_tpu_torch.parallel.mesh import data_parallel_group, rows, sync_gradients
    from medfusion_tpu_torch.parallel.moe import MoEMLP

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    rank = mesh.get_local_rank("data")
    m = MoEMLP(**MOE_KW, expert_axis=mesh["data"])
    sd = {k: (rows(v, rank, world) if k != "router.weight" else v)
          for k, v in inp["moe"].items()}
    m.load_state_dict(sd, strict=True)
    x = rows(inp["moe_x"], rank, world)
    y, aux = m(x)
    # each rank's share of the whole batch's sum(y^2): the data-parallel mean
    # of world * local sums is the JAX test's loss
    loss = world * (y ** 2).sum()
    loss.backward()
    sync_gradients(m, data_parallel_group(m))
    return {"y": y.detach(), "aux": aux.detach(), "loss": loss.detach(),
            "grads": {k: p.grad.clone() for k, p in m.named_parameters()}}


def case_dit_moe(inp, world):
    from medfusion_tpu_torch.models.dit import DiT
    from medfusion_tpu_torch.parallel import make_mesh
    from medfusion_tpu_torch.parallel.mesh import layout, local_piece, rows

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    rank = mesh.get_local_rank("data")
    dit = DiT(**DIT_KW, moe_expert_axis=mesh["data"])
    lay = layout(dit)
    dit.load_state_dict({k: local_piece(lay[k], v) if k in lay else v
                         for k, v in inp["dit"].items()}, strict=True)
    x = rows(inp["dit_x"], rank, world)
    t = rows(inp["dit_t"], rank, world)
    c = rows(inp["dit_c"], rank, world)
    with torch.no_grad():
        y, _, aux = dit(x, t, c, with_aux=True)
    return {"y": y, "aux": aux}


def case_prefetch(inp, world):
    from medfusion_tpu_torch.data.prefetch import prefetch_to_device
    from medfusion_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=world, n_model=1, device="cpu")
    batches = [{"x": torch.arange(8.0).reshape(4, 2) + 10 * i, "uid": [f"u{i}"]}
               for i in range(3)]
    return {"batches": list(prefetch_to_device(iter(batches), device="cpu", mesh=mesh))}


def case_sample_dataset(inp, world):
    from medfusion_tpu_torch.cli import sample_dataset

    sample_dataset.main(inp["sample_dataset_argv"] + ["--out", inp["sample_dataset_out"]])
    return {}


# ---- suite: pipeline ---------------------------------------------------------------


def stage_tanh(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def stage_rms(p, x):
    # per-sample RMS norm with no eps: a zero activation would give 0/0
    h = x @ p["w"]
    return h / torch.sqrt((h ** 2).mean(dim=-1, keepdim=True))


def stage_gain(p, x):
    return torch.tanh(x @ p["w"]) * p["gain"]


STAGES = {"tanh": stage_tanh, "rms": stage_rms, "gain": stage_gain}


def _pipeline_case(spec, world):
    """One ``pipeline_apply`` of ``spec`` (a dict the parent made): the
    output, and with ``loss`` the gradient of this rank's parameters (the
    stacked tree's row of this rank's stage, or its ZeRO slice)."""
    from medfusion_tpu_torch.parallel import (
        make_mesh,
        pipeline_apply,
        shard_stage_params,
        stack_stage_params,
    )

    mesh = make_mesh(*spec["mesh"], device="cpu")
    stacked = stack_stage_params(spec["stages"])
    if spec.get("shard"):
        stacked = shard_stage_params(stacked, mesh, zero_axis=spec.get("zero_axis"))
    params = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    kw = {k: spec[k] for k in ("n_microbatches", "data_axis", "zero_axis") if k in spec}
    try:
        y = pipeline_apply(STAGES[spec["stage"]], params, spec["x"], mesh=mesh, axis="model",
                           **kw)
    except ValueError as e:
        return {"raised": str(e)}
    out = {"y": y.detach(), "stage": mesh.get_local_rank("model"),
           "data": mesh.get_local_rank("data")}
    if spec.get("loss"):
        loss = (y ** 2).mean() if spec["loss"] == "mean" else (y ** 2).sum()
        loss.backward()
        out["grads"] = {k: v.grad.clone() for k, v in params.items()}
    return out


def case_pipelines(inp, world):
    return {name: _pipeline_case(spec, world) for name, spec in inp["pipelines"][world].items()}


# ---- suite: multihost ---------------------------------------------------------------


def case_multihost(inp, world, rank, port, tmp):
    """Bring-up, one collective and the coordinated checkpoint of an
    FSDP-sharded state with EMA and Adam moments."""
    import torch.distributed as dist
    from torch.func import functional_call

    from medfusion_tpu_torch.parallel import make_mesh, shard_batch, shard_params
    from medfusion_tpu_torch.parallel.mesh import layout, local_piece, whole
    from medfusion_tpu_torch.parallel.multihost import initialize_multihost, per_host_batch_slice
    from medfusion_tpu_torch.train import TrainState
    from medfusion_tpu_torch.train.diffusion import estimator_params, train_on
    from medfusion_tpu_torch.utils import checkpoint as C

    addr = f"127.0.0.1:{port}"
    info = initialize_multihost(addr, num_processes=world, process_id=rank, device="cpu")
    again = initialize_multihost(addr, num_processes=world, process_id=rank, device="cpu")
    sl = per_host_batch_slice(8)
    total = torch.arange(8.0)[sl].sum()
    dist.all_reduce(total)
    mesh = make_mesh(n_model=1, device="cpu")

    def model_and_state():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Linear(16, 8))
        shard_params(model, mesh, fsdp=True, fsdp_min_size=16)
        return model, TrainState(model, lr=0.1, use_ema=True)

    model, state = model_and_state()
    x = shard_batch(inp["x"], mesh)
    for _ in range(2):
        train_on(state, None, lambda p: ((functional_call(model, p, (x,)) ** 2).mean(), {}))
    ckpt = tmp / "ckpt"
    C.save_checkpoint(ckpt, state, step=7)
    saved = C.load_payload(ckpt)["state"]
    lay = layout(model)
    mine = {k: p.detach().clone() for k, p in model.named_parameters()}
    moments = [s["exp_avg"].clone() for s in state.optimizer.state.values()]
    ema = {k: p.detach().clone() for k, p in state.ema.named_parameters()}
    whole_params = {k: whole(lay[k], v) if k in lay else v for k, v in mine.items()}

    model2, state2 = model_and_state()
    with torch.no_grad():
        for p in model2.parameters():
            p.zero_()
    C.restore_checkpoint(ckpt, state2)
    return {
        "info": info, "again": again, "slice": (sl.start, sl.stop), "total": float(total),
        "backend": dist.get_backend(), "mesh": tuple(mesh.shape), "sharded": sorted(lay),
        "latest": C.latest_step(ckpt), "step": state2.step,
        "saved_whole": all(torch.equal(saved["model"][k], v) for k, v in whole_params.items()),
        "saved_shapes": {k: tuple(v.shape) for k, v in saved["model"].items()},
        "local_shapes": {k: tuple(v.shape) for k, v in mine.items()},
        "restored": all(torch.equal(p, mine[k]) for k, p in model2.named_parameters()),
        "restored_ema": all(torch.equal(p, ema[k]) for k, p in state2.ema.named_parameters()),
        "restored_moments": all(torch.equal(s["exp_avg"], m) for s, m in
                                zip(state2.optimizer.state.values(), moments)),
        "pieces": all(torch.equal(local_piece(lay[k], saved["model"][k]), mine[k])
                      for k in lay),
        "params_dict": sorted(k for k, v in estimator_params(model).items()
                              if tuple(v.shape) == tuple(saved["model"][k].shape)),
    }


SUITES = {
    "parallel": {2: [case_train_dp, case_train_fsdp, case_train_fsdp_tp, case_tp_spatial,
                     case_dit_specs, case_sync_counters,
                     case_sampler, case_ring_attention, case_ring_attention_grad, case_moe,
                     case_dit_moe, case_prefetch, case_sample_dataset],
                 4: [case_train_fsdp_tp, case_ring_attention_grad]},
    "pipeline": {2: [case_pipelines], 4: [case_pipelines]},
    "multihost": {2: [case_multihost]},
}


def main(argv):
    import torch.distributed as dist

    suite, rank, world, port, tmp = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), \
        Path(argv[4])
    torch.set_num_threads(1)
    cases = SUITES[suite][world]
    # the port's imports and the group first: they overlap the parent's work
    import medfusion_tpu_torch.cli.sample_dataset  # noqa: F401
    import medfusion_tpu_torch.train  # noqa: F401

    if suite != "multihost":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
    inp = _read_inputs(tmp)
    for fn in cases:
        name = fn.__name__[len("case_"):]
        try:
            out = fn(inp, world) if suite != "multihost" else fn(inp, world, rank, port, tmp)
        except Exception:
            out = {"error": traceback.format_exc()}
        torch.save(out, tmp / f"{name}_{world}_{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
