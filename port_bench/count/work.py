"""The work a cell's round asks for, counted on the plain reference at the
cell's shapes on the meta device (no memory, no arithmetic):

* model FLOPs by ``torch.utils.flop_counter.FlopCounterMode``: a sampling
  chunk is ``steps`` UNet forwards and one decode of its rows; a training
  step is the forward and backward of the loss and the frozen encode of a
  rank's rows. Recomputation is not counted: the reference recomputes
  nothing.
* the hand-written kernels' calls [(kind, shape)] that the same round
  presents (``reference/model.py::Probe``): in training the GroupNorm and
  GEGLU forwards and each attention's forward and backward, since the port's
  GroupNorm and GEGLU backwards recompute through plain operations and
  launch no kernel of their own."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import model as R


def _meta_models(cfg):
    with torch.device("meta"):
        return R.build(cfg, "unet"), R.build(cfg, "vae")


def _inputs(cfg, rows, image):
    lat = cfg["latent_size"]
    with torch.device("meta"):
        x = (torch.empty(rows, cfg["image_channels"], cfg["image_size"], cfg["image_size"])
             if image else torch.empty(rows, cfg["latent_channels"], lat, lat))
        return (x, torch.zeros(rows, dtype=torch.long), torch.zeros(rows, dtype=torch.long),
                torch.ones(rows))


def sample_chunk(cfg, rows: int, steps: int) -> dict:
    """{'flops', 'calls'} of one chunk of ``rows`` images."""
    unet, vae = _meta_models(cfg)
    probe = R.Probe()
    R.set_probe(unet, probe)
    R.set_probe(vae, probe)
    z, t, c, m = _inputs(cfg, rows, image=False)
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            unet(z, t, c, m)
        unet_flops, unet_calls = fc.get_total_flops(), list(probe.calls)
        probe.calls.clear()
        with FlopCounterMode(display=False) as fc:
            vae.decode(z)
        decode_flops, decode_calls = fc.get_total_flops(), list(probe.calls)
    return {"flops": steps * unet_flops + decode_flops,
            "calls": unet_calls * steps + decode_calls,
            "unet_flops": unet_flops, "decode_flops": decode_flops}


def train_step(cfg, rows: int) -> dict:
    """{'flops', 'calls'} of one training step on ``rows`` rows."""
    unet, vae = _meta_models(cfg)
    probe = R.Probe()
    R.set_probe(unet, probe)
    R.set_probe(vae, probe)
    x, t, c, m = _inputs(cfg, rows, image=True)
    lat = cfg["latent_size"]
    with torch.device("meta"):
        noise = torch.empty(rows, cfg["latent_channels"], lat, lat)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            z = vae.encode(x, noise)
        loss = (unet(z, t, c, m) - noise).abs().mean()
        loss.backward()
    calls = list(probe.calls)
    calls += [("attention_bwd", shape) for kind, shape in calls if kind == "attention"]
    return {"flops": fc.get_total_flops(), "calls": calls}
