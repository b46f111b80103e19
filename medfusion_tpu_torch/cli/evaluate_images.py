"""FID and improved precision/recall between two image trees (port of
``medfusion_tpu/cli/evaluate_images.py``).

The reference's evaluation script: every image under ``--real`` and
``--fake`` (``.png``, ``.jpg``, ``.jpeg``, ``.tif``, ``.tiff``, ``.bmp``, in
sorted order) read as uint8 RGB, optionally resized to ``--size`` square
(PIL's bilinear filter, ``data/transforms.py::resize``), featurised by
InceptionV3 (2048-d) in batches of ``--batch-size`` on the card; FID (float64
on the host) and improved precision/recall with k = 3 (on the card). The
result is printed as one JSON line and written to
``<out>/metrics_<timestamp>.json``, with the seconds of reading,
featurising and computing.

PNGs are read by the port's own decoder; other formats need PIL, and the
error says so (the card's machine has no PIL).

Weights: ``--inception-weights`` is an ``.npz`` of a torch-fidelity /
pytorch-fid state dict (the file the JAX CLI's flag takes); otherwise an
ingested artifact (``cli.ingest_weights inception``) when there is one;
otherwise a seeded random network, with a warning that the numbers are not
comparable with published ones.

Usage:
  python -m medfusion_tpu_torch.cli.evaluate_images --real path/a --fake path/b \\
      [--inception-weights weights.npz] [--size 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from medfusion_tpu_torch import resolve_device
from medfusion_tpu_torch.cli.presets import seeded
from medfusion_tpu_torch.data.png import read_rgb
from medfusion_tpu_torch.data.transforms import resize
from medfusion_tpu_torch.metrics import (
    FrechetInceptionDistance,
    ImprovedPrecisionRecall,
    InceptionV3,
)
from medfusion_tpu_torch.utils import pretrained as P

EXTS = {".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp"}
WARNING = ("WARNING: no pretrained InceptionV3 available — features are a random "
           "projection; FID/P/R are self-consistent but NOT comparable to published "
           "numbers (ingest the torch weights via cli.ingest_weights for parity)")


def iter_uint8_batches(folder, batch_size: int, size: Optional[int] = None,
                       timing: Optional[Dict[str, float]] = None) -> Iterator[np.ndarray]:
    """uint8 [B, H, W, 3] batches of the images under ``folder``; the
    seconds spent reading are added to ``timing["read"]``."""
    paths = sorted(p for p in Path(folder).rglob("*") if p.suffix.lower() in EXTS)
    if not paths:
        raise FileNotFoundError(f"no images under {folder}")
    for i in range(0, len(paths), batch_size):
        t0 = time.perf_counter()
        imgs = [read_rgb(p) for p in paths[i:i + batch_size]]
        if size is not None:
            imgs = [resize(im, (size, size)) for im in imgs]
        batch = np.stack(imgs)
        if timing is not None:
            timing["read"] = timing.get("read", 0.0) + time.perf_counter() - t0
        yield batch


def load_inception(device, weights: Optional[str] = None, seed: int = 0) -> InceptionV3:
    """The featuriser on ``device`` in eval mode: from ``weights`` (an
    ``.npz`` state dict), else the ingested artifact, else seeded random
    weights (with the warning)."""
    from medfusion_tpu_torch.metrics.inception import fid_state_dict

    with seeded(device, seed):
        net = InceptionV3()
    if weights:
        with np.load(weights) as raw:
            sd = fid_state_dict({k: torch.from_numpy(np.array(raw[k])) for k in raw.files})
        net.load_state_dict(sd, strict=True)
    elif (ingested := P.load_pretrained(P.INCEPTION)) is not None:
        net.load_state_dict(ingested, strict=True)
        print(f"using ingested InceptionV3 weights from {P.artifact_path(P.INCEPTION)}")
    else:
        print(WARNING)
    return net.eval().requires_grad_(False)


@torch.no_grad()
def featurize_folder(net: InceptionV3, folder, batch_size: int, size: Optional[int] = None,
                     timing: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """[N, 2048] float32 features of the images under ``folder`` on the
    featuriser's device; the seconds spent featurising are added to
    ``timing["featurize"]``."""
    dev = next(net.parameters()).device
    feats = []
    for batch in iter_uint8_batches(folder, batch_size, size, timing):
        t0 = time.perf_counter()
        feats.append(net(torch.from_numpy(batch).to(dev).permute(0, 3, 1, 2).contiguous()))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if timing is not None:
            timing["featurize"] = timing.get("featurize", 0.0) + time.perf_counter() - t0
    return torch.cat(feats)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--real", required=True)
    ap.add_argument("--fake", required=True)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--size", type=int, default=None,
                    help="resize images to SIZE x SIZE before featurising")
    ap.add_argument("--inception-weights", default=None,
                    help=".npz of a torch-fidelity state dict; else the ingested "
                         "artifact; else random weights")
    ap.add_argument("--out", default="results/metrics")
    ap.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    net = load_inception(resolve_device(args.device), args.inception_weights, args.seed)
    fid, ipr = FrechetInceptionDistance(), ImprovedPrecisionRecall(knn=3)
    timing = {"read": 0.0, "featurize": 0.0}
    counts = {}
    for real, folder in ((True, args.real), (False, args.fake)):
        feats = featurize_folder(net, folder, args.batch_size, args.size, timing)
        fid.update(feats, real=real)
        ipr.update(feats, real=real)
        counts["real" if real else "fake"] = feats.shape[0]
        print(f"{'real' if real else 'fake'}: {feats.shape[0]} images featurized")
    t0 = time.perf_counter()
    fid_val = fid.compute()
    precision, recall = ipr.compute()
    timing["compute"] = time.perf_counter() - t0
    result = {"FID": fid_val, "precision": precision, "recall": recall,
              "time": time.strftime("%Y-%m-%d %H:%M:%S"),
              "n_real": counts["real"], "n_fake": counts["fake"],
              **{f"seconds_{k}": v for k, v in timing.items()}}
    print(json.dumps(result))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"metrics_{time.strftime('%Y_%m_%d_%H%M%S')}.json").write_text(
        json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
