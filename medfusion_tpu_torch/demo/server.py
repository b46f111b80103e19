"""Browser demo and serving endpoint (port of ``medfusion_tpu/demo/server.py``).

Pages on the standard library's ``http.server``: ``/`` a form (samples <=
25, steps <= 999, guidance, condition, seed), ``/sample`` a page of images
sampled by DDIM at the preset's latent shape (the flow family's Heun ODE,
at most 50 steps), ``/img`` one PNG of such a page, and ``/one`` one image
per request, micro-batched (``demo/serving.py``): concurrent requests share
one fixed-shape batch of ``--serve-batch`` (DDIM 50 steps at eta 0, 25 Heun
steps for flow, guidance 4). Pages are kept in a request-keyed LRU of 8
batches; concurrent fetches of one key (a page's ``/img`` tags) wait for one
sampling run. PNGs are written by ``data/png.py`` (no PIL).

The pipeline is the one ``cli.sample`` builds: ``--ckpt`` a port diffusion
run or a reference Lightning ``.ckpt``, ``--vae-ckpt`` a port autoencoder run,
an ``.npz`` or a ``.ckpt``, else seeded random weights; ``--dtype`` its
compute dtype. It runs on ``--device`` (``cuda`` by default; without CUDA
that raises unless ``--device cpu`` is given). On the card the server builds
every kernel and runs one warm-up step of the ``/one`` batch before it
serves, so no request waits on ``nvcc`` and no two threads build at once.

Usage:
  python -m medfusion_tpu_torch.demo.server --preset chest [--ckpt ...] \\
      [--vae-ckpt ...] [--port 8600] [--serve-batch 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from medfusion_tpu_torch import resolve_device
from medfusion_tpu_torch.cli.kernels import add_kernel_args, resolve_kernel_flags
from medfusion_tpu_torch.cli.presets import ESTIMATORS, PRESETS, build_pipeline
from medfusion_tpu_torch.cli.sample import DTYPES, load_unet_state, vae_source
from medfusion_tpu_torch.cli.sample_dataset import to_uint8
from medfusion_tpu_torch.data.png import encode_png

_PAGE = """<!doctype html><html><head><title>medfusion-tpu demo</title>
<style>body{{font-family:sans-serif;max-width:760px;margin:2em auto}}
img{{image-rendering:pixelated;border:1px solid #ccc;margin:2px}}</style></head>
<body><h1>medfusion-tpu — {name}</h1>
<p>Medical image synthesis with a latent diffusion model, on PyTorch.</p>
<form action="/sample" method="get">
preset <select name="preset">{options}</select>
samples <input type="number" name="n" value="4" min="1" max="25">
steps <input type="number" name="steps" value="50" min="1" max="999">
guidance <input type="number" name="guidance" value="8" min="1" max="10">
condition <input type="number" name="cond" value="1" min="0" max="1">
seed <input type="number" name="seed" value="0">
<button type="submit">sample</button></form>
{body}</body></html>"""

ONE_STEPS = {"diffusion": 50, "flow": 25}  # /one's fixed sampling
ONE_GUIDANCE = 4.0
FLOW_MAX_STEPS = 50


def load_pipeline(args, p):
    """The pipeline of ``args`` for preset ``p``, as ``cli.sample`` builds it
    (eps objective, no latent scaling)."""
    family = getattr(args, "family", "diffusion")
    estimator = getattr(args, "estimator", "unet")
    attention = getattr(args, "attention", "none")
    heads = getattr(args, "attention_heads", 8)
    unet_state = None
    if args.ckpt:
        unet_state = load_unet_state(args.ckpt, args.ema, {
            "estimator": estimator, "attention": attention, "attention_heads": heads,
            "objective": "x_T", "latent_scale": 1.0, "latent_shift": 0.0,
            "zero_terminal_snr": False, "family": family})
    return build_pipeline(p, device=getattr(args, "device", None),
                          compute_dtype=DTYPES[getattr(args, "dtype", "bf16")],
                          seed=args.seed, attention=attention, attn_heads=heads,
                          unet_state=unet_state, vae_ckpt=vae_source(args), family=family,
                          flow_shift=getattr(args, "flow_shift", 1.0), estimator=estimator)


def png_of(img: np.ndarray) -> bytes:
    """uint8 [H, W, C] -> PNG bytes (grey for one channel)."""
    return encode_png(img[:, :, 0] if img.shape[-1] == 1 else img)


class DemoState:
    """Pipelines and sampled pages, keyed by the full request, so that
    concurrent users never see each other's images; one :class:`MicroBatcher`
    a preset for ``/one``."""

    _MAX_BATCHES = 8

    def __init__(self, args):
        self.args = args
        self._cache = {}
        self._images = OrderedDict()
        self._lock = threading.Lock()
        self._inflight = {}
        self._batchers = {}

    def pipeline(self, preset_name):
        """(preset, pipeline), built once a preset."""
        with self._lock:
            if preset_name not in self._cache:
                p = PRESETS[preset_name]
                self._cache[preset_name] = (p, load_pipeline(self.args, p))
            return self._cache[preset_name]

    def batcher(self, preset_name):
        """The preset's ``/one`` batcher (``demo/serving.py``)."""
        from medfusion_tpu_torch.demo.serving import MicroBatcher, make_sample_batch_fn

        p, pipe = self.pipeline(preset_name)
        with self._lock:
            if preset_name not in self._batchers:
                fam = getattr(self.args, "family", "diffusion")
                steps = ONE_STEPS[fam] if fam == "flow" else min(ONE_STEPS[fam], p.timesteps)
                fn = make_sample_batch_fn(pipe, p.latent_shape, steps=steps,
                                          guidance_scale=ONE_GUIDANCE,
                                          conditional=bool(p.num_classes), family=fam,
                                          base_seed=self.args.seed)
                self._batchers[preset_name] = MicroBatcher(fn, batch_size=self.args.serve_batch)
        return self._batchers[preset_name]

    def warm(self, preset_name):
        """One sampling step and a decode of a ``/one`` batch, so that every
        kernel the preset launches is built and loaded before serving."""
        p, pipe = self.pipeline(preset_name)
        b = self.args.serve_batch
        with torch.inference_mode():
            x = torch.zeros((b, *p.latent_shape), device=pipe.device)
            cond = (torch.zeros((b,), dtype=torch.long, device=pipe.device)
                    if p.num_classes else None)
            if getattr(self.args, "family", "diffusion") == "flow":
                pipe.denoise(x, condition=cond, steps=1, guidance_scale=ONE_GUIDANCE)
            else:
                pipe.denoise(x, condition=cond, steps=1, use_ddim=True, eta=0.0,
                             guidance_scale=ONE_GUIDANCE)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    def close(self):
        with self._lock:
            batchers = list(self._batchers.values())
        for b in batchers:
            b.close()

    def images_for(self, preset, n, steps, guidance, cond_val, seed):
        """uint8 [n, H, W, C] of the request key: sampled once, LRU-cached;
        concurrent requests for one key wait for a single sampling run."""
        key = (preset, n, steps, guidance, cond_val, seed)
        while True:
            with self._lock:
                if key in self._images:
                    self._images.move_to_end(key)
                    return self._images[key]
                event = self._inflight.get(key)
                if event is None:
                    event = self._inflight[key] = threading.Event()
                    break  # this thread samples
            event.wait(timeout=600)  # another thread is sampling this key

        try:
            p, pipe = self.pipeline(preset)
            dev = pipe.device
            cond = (torch.full((n,), cond_val, dtype=torch.long, device=dev)
                    if p.num_classes else None)
            gs = guidance if cond is not None else 1.0
            gen = torch.Generator(device=dev).manual_seed(seed)
            with torch.inference_mode():
                if getattr(self.args, "family", "diffusion") == "flow":
                    imgs = pipe.sample(n, p.latent_shape, condition=cond, generator=gen,
                                       steps=min(steps, FLOW_MAX_STEPS), guidance_scale=gs)
                else:
                    imgs = pipe.sample(n, p.latent_shape, condition=cond, generator=gen,
                                       steps=min(steps, p.timesteps), use_ddim=True,
                                       guidance_scale=gs)
            arr = to_uint8(imgs.float().cpu().numpy())
            with self._lock:
                self._images[key] = arr
                self._images.move_to_end(key)
                while len(self._images) > self._MAX_BATCHES:
                    self._images.popitem(last=False)
            return arr
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            event.set()


def make_handler(state: DemoState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, data: bytes, kind: str):
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _html(self, body=""):
            options = "".join(
                f'<option value="{k}"{" selected" if k == state.args.preset else ""}>{k}</option>'
                for k in sorted(PRESETS))
            self._send(_PAGE.format(name=state.args.preset, options=options,
                                    body=body).encode(), "text/html")

        @staticmethod
        def _request_key(q):
            return dict(
                preset=q.get("preset", state.args.preset),
                n=min(int(q.get("n", 4)), 25),
                steps=min(int(q.get("steps", 50)), 999),
                guidance=float(q.get("guidance", 8)),
                cond_val=int(q.get("cond", 1)),
                seed=int(q.get("seed", 0)),
            )

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                return self._html()
            if url.path == "/sample":
                key = self._request_key(q)
                arr = state.images_for(**key)
                query = (f"preset={key['preset']}&n={key['n']}&steps={key['steps']}"
                         f"&guidance={key['guidance']}&cond={key['cond_val']}"
                         f"&seed={key['seed']}")
                tags = "".join(f'<img src="/img?{query}&i={i}" width="128">'
                               for i in range(arr.shape[0]))
                return self._html(f"<h2>{key['n']} samples, {key['steps']} steps</h2>{tags}")
            if url.path == "/one":
                preset = q.get("preset", state.args.preset)
                if preset not in PRESETS:
                    self.send_error(400, f"unknown preset {preset!r}")
                    return
                try:
                    seed = int(q.get("seed", 0))
                    cond = int(q.get("cond", 1))
                except ValueError:
                    self.send_error(400, "seed/cond must be integers")
                    return
                try:
                    fut = state.batcher(preset).submit(seed=seed, cond=cond)
                    img = to_uint8(fut.result(timeout=600).numpy())
                except Exception as e:  # noqa: BLE001 - surface as HTTP 500
                    self.send_error(500, f"sampling failed: {type(e).__name__}")
                    return
                return self._send(png_of(img), "image/png")
            if url.path == "/img":
                i = int(q.get("i", 0))
                arr = state.images_for(**self._request_key(q))
                if i >= arr.shape[0]:
                    self.send_response(404)
                    self.end_headers()
                    return
                return self._send(png_of(arr[i]), "image/png")
            self.send_response(404)
            self.end_headers()

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="smoke")
    ap.add_argument("--ckpt", default=None,
                    help="a port diffusion run, or a reference Lightning .ckpt")
    ap.add_argument("--vae-ckpt", default=None,
                    help="a port autoencoder run, an .npz of the JAX VAE's params, or a "
                         "reference Lightning .ckpt")
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--family", choices=("diffusion", "flow"), default="diffusion",
                    help="flow = serve a flow-matching checkpoint (Heun ODE sampler)")
    ap.add_argument("--flow-shift", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--serve-batch", type=int, default=4,
                    help="micro-batch size of the /one endpoint")
    ap.add_argument("--estimator", default="unet", choices=ESTIMATORS,
                    help="the noise-estimator family the checkpoint was trained with")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    add_kernel_args(ap)
    args = ap.parse_args(argv)
    resolve_kernel_flags(args, ap)
    if args.ema and not args.ckpt:
        ap.error("--ema needs --ckpt")
    return args


def make_server(args):
    """(HTTP server on 127.0.0.1:``args.port``, its :class:`DemoState`),
    with the preset's pipeline loaded and, on the card, every kernel built
    and warmed; serving is the caller's ``serve_forever``."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from medfusion_tpu_torch.ops import build

        build.build_all()
    state = DemoState(args)
    if dev.type == "cuda":
        state.warm(args.preset)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(state))
    return server, state


def main(argv=None):
    server, state = make_server(parse_args(argv))
    print(f"demo listening on http://127.0.0.1:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        state.close()


if __name__ == "__main__":
    main()
