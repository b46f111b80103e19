"""The plain reference held to the port at a size the CPU holds: both run in
float32 from one seeded state dict, loaded into each with ``strict=True``."""

from __future__ import annotations

import torch

from port_bench.harness import check, program, sampling, seeded, training
from port_bench.reference import diffusion as RD
from port_bench.reference import model as R
from port_bench.tests import smoke

DEV = torch.device("cpu")


def _pair(cfg, seed=3):
    sd_unet, sd_vae = program.seeded_weights(cfg, seed, DEV)
    pipe = program.sampling_pipeline({**cfg, "compute_dtype": "float32"}, sd_unet, sd_vae, DEV)
    ref_unet, ref_vae = program.reference_models(cfg, sd_unet, sd_vae, DEV)
    return pipe, ref_unet, ref_vae


def test_unet_and_vae_match_the_port():
    torch.set_num_threads(2)
    for attention in ("none", "spatial"):
        cfg = smoke.config(attention=attention)
        pipe, ref_unet, ref_vae = _pair(cfg)
        g = torch.Generator().manual_seed(0)
        z = torch.randn(3, cfg["latent_channels"], 8, 8, generator=g)
        t = torch.tensor([0, 7, 19])
        c = torch.tensor([0, 1, 1])
        m = torch.tensor([1.0, 0.0, 1.0])
        with torch.no_grad():
            got, _ = pipe.noise_estimator(z, t, c, m)
            want = ref_unet(z, t, c, m)
            assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), attention
            x = torch.randn(2, 3, 32, 32, generator=g)
            noise = torch.randn(2, cfg["latent_channels"], 8, 8, generator=g)
            assert torch.allclose(pipe.latent_embedder.encode(x, noise),
                                  ref_vae.encode(x, noise), rtol=1e-4, atol=1e-5)
            assert torch.allclose(pipe.latent_embedder.decode(z), ref_vae.decode(z),
                                  rtol=1e-4, atol=1e-5)
        assert want.abs().mean() > 1e-2  # every tensor seeded: no zero output layer


def test_sampled_images_match_the_port():
    torch.set_num_threads(2)
    c = smoke.f32(smoke.cell("sample"))
    d = sampling.Sampling(c, 11, DEV)
    d.images.append(d._chunk(0, d.sampler, d.steps))
    d.images.append(d._chunk(1, d.sampler, d.steps))
    sample, kept = d.release()
    assert len(sample) == 8 and {ch for ch, _ in sample} == {0, 1}
    ref = sampling.reference_images(c.config, c.traffic, 11, sample, DEV)
    assert check.image_gap(kept, ref) < 1e-5


def test_training_readings_match_the_port():
    torch.set_num_threads(2)
    c = smoke.f32(smoke.cell("train"))
    d = training.Training(c, 12, DEV)
    d.prepare()
    prog = d.release()
    ref = training.reference_readings(c.config, c.traffic, 12, DEV, judged=prog["grad_full"])
    numbers = check.train_numbers(prog, ref)
    assert numbers["loss"] < 1e-5 and numbers["grad"] < 1e-4, numbers
    assert numbers["change"] < 1e-3 and numbers["ema"] < 1e-3, numbers
    assert numbers["grad_diff_median_leaf"] < 1e-4, numbers


def test_reference_adamw_is_torch_adamw():
    cfg = smoke.config()
    g = torch.Generator().manual_seed(1)
    a = torch.randn(5, 4, generator=g, requires_grad=True)
    b = a.detach().clone().requires_grad_(True)
    opt = torch.optim.AdamW([a], lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    ref = RD.AdamW([b], cfg)
    for _ in range(3):
        grad = torch.randn(5, 4, generator=g)
        a.grad, b.grad = grad.clone(), grad.clone()
        opt.step()
        ref.step()
    assert torch.allclose(a, b, rtol=0, atol=1e-7)


def test_ema_decay_warms_up_from_zero():
    cfg = smoke.config()
    assert RD.ema_decay(0, cfg) == 0.0 and RD.ema_decay(1, cfg) == 0.0
    assert abs(RD.ema_decay(2, cfg) - (1 - 2 ** (-2 / 3))) < 1e-12


def test_seeded_streams_repeat_and_differ():
    cfg = smoke.config()
    big = 2 ** 33 + 5  # seeds beyond 32 bits
    a = seeded.chunk(cfg, big, 3, 2, 4, DEV)[0]
    assert torch.equal(a, seeded.chunk(cfg, big, 3, 2, 4, DEV)[0])
    assert not torch.equal(a, seeded.chunk(cfg, big, 4, 2, 4, DEV)[0])
    b0, _ = seeded.batch(cfg, big, 0, 0, 2, DEV)
    b1, _ = seeded.batch(cfg, big, 0, 1, 2, DEV)
    assert not torch.equal(b0["source"], b1["source"])
    with torch.device("meta"):
        unet = R.build(cfg, "unet")
    w = seeded.weights(unet, big, "unet", DEV)
    assert set(w) == {n for n, _ in unet.named_parameters()}
    assert all(v.abs().sum() > 0 for v in w.values())
