"""Ingest pretrained torch weights for the evaluation networks (port of
``medfusion_tpu/cli/ingest_weights.py``).

Given the checkpoint files the reference's stack downloads at run time —
torch-fidelity / pytorch-fid InceptionV3 (``pt_inception-2015-12-05-*.pth``)
and torchvision VGG16 for lpips (``vgg16-397923af.pth``) — keep what the
port's module holds (the featuriser: pytorch-fid's wrapper keys renamed, the
``AuxLogits``/``fc`` heads dropped; VGG16: its ``features``), check it key by
key against the module (every missing, unexpected or mis-shaped tensor
listed), save it in the store (``utils/pretrained.py``) and print one JSON
line with the hashes. The port's modules carry the torch key names, so no
tensor is converted.

Usage:
  python -m medfusion_tpu_torch.cli.ingest_weights inception --src pt_inception-2015-12-05-6726825d.pth
  python -m medfusion_tpu_torch.cli.ingest_weights vgg16 --src vgg16-397923af.pth

``--src`` takes ``.pth``/``.pt`` (``torch.load`` on the CPU with
``weights_only=True``) and ``.npz`` (a state dict exported to numpy).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from medfusion_tpu_torch.utils import pretrained as P


def load_state_dict(src: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint (a state dict, or a dict holding one under
    ``state_dict``) or an ``.npz`` export, as {key: tensor} on the CPU."""
    if str(src).endswith(".npz"):
        with np.load(src) as raw:
            return {k: torch.from_numpy(np.array(raw[k])) for k in raw.files}
    obj = torch.load(src, map_location="cpu", weights_only=True)
    if isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def ingest_inception(src: str):
    from medfusion_tpu_torch.metrics.inception import InceptionV3, fid_state_dict

    sd = fid_state_dict(load_state_dict(src))
    with torch.device("meta"):
        template = InceptionV3().state_dict()
    P.validate_against_template(sd, template, "inception")
    return sd, P.INCEPTION


def ingest_vgg16(src: str):
    from medfusion_tpu_torch.losses.lpips import VGG16Features, convert_torch_vgg16

    sd = convert_torch_vgg16(load_state_dict(src))
    with torch.device("meta"):
        template = VGG16Features().state_dict()
    P.validate_against_template(sd, template, "vgg16")
    return sd, P.VGG16


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kind", choices=["inception", "vgg16"])
    ap.add_argument("--src", required=True, help=".pth/.pt torch checkpoint or .npz export")
    args = ap.parse_args(argv)

    sd, name = (ingest_inception if args.kind == "inception" else ingest_vgg16)(args.src)
    path = P.save_pretrained(name, sd)
    result = {"artifact": str(path), "name": name, "src_sha256": P.file_sha256(args.src),
              "params_sha256": P.params_sha256(sd), "n_leaves": len(sd)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
