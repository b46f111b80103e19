"""3-D volume dataset (port of ``medfusion_tpu/data/datasets_3d.py``):
``SimpleDataset3D`` and ``crop_or_pad``.

The reference's ``SimpleDataset3D`` reads NIfTI through torchio; here a
crawler over ``.npy``/``.npz`` volumes ([D, H, W] or [D, H, W, C]) or
single-file NIfTI (``data/nifti.py``; ``crawler_ext="nii.gz"``), then a
nearest-exact resize, random flips of each axis, a centre crop-or-pad, and
z-normalisation or a rescale to [-1, 1]. Items are {'uid', 'source'} with a
channels-last float32 [D, H, W, C] source, as the JAX package gives; each
item's flips draw from the dataset's one ``rng``, in the order the items are
read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from medfusion_tpu_torch.nn.functional import interpolate_nearest_exact


def crop_or_pad(vol: np.ndarray, target: Sequence[Optional[int]]) -> np.ndarray:
    """Centre crop or zero-pad each leading dim to ``target``; None keeps
    that dim's size."""
    out = vol
    for axis, t in enumerate(target):
        if t is None or out.shape[axis] == t:
            continue
        s = out.shape[axis]
        if s > t:
            start = (s - t) // 2
            out = np.take(out, range(start, start + t), axis=axis)
        else:
            pad = [(0, 0)] * out.ndim
            pad[axis] = ((t - s) // 2, t - s - (t - s) // 2)
            out = np.pad(out, pad)
    return out


def resize_volume(vol: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """Nearest-exact resize of a channels-last [D, H, W, C] volume."""
    x = torch.from_numpy(np.ascontiguousarray(vol, np.float32)).movedim(-1, 0)[None]
    return interpolate_nearest_exact(x, tuple(size))[0].movedim(0, -1).numpy()


class SimpleDataset3D:
    def __init__(self, path_root, item_pointers: Sequence = (), crawler_ext: str = "npy",
                 transform=None, image_resize: Optional[Tuple[int, int, int]] = None,
                 flip: bool = False, image_crop: Optional[Tuple[Optional[int], ...]] = None,
                 use_znorm: bool = True, seed: int = 0):
        self.path_root = Path(path_root)
        self.rng = np.random.default_rng(seed)
        self.item_pointers = (
            list(item_pointers) if len(item_pointers)
            else sorted(p.relative_to(self.path_root)
                        for p in self.path_root.rglob(f"*.{crawler_ext}")))
        self.transform = transform
        self.image_resize = image_resize
        self.flip = flip
        self.image_crop = image_crop
        self.use_znorm = use_znorm

    def __len__(self):
        return len(self.item_pointers)

    def load_item(self, path_item) -> np.ndarray:
        name = Path(path_item).name.lower()
        if name.endswith(".nii") or name.endswith(".nii.gz"):
            from medfusion_tpu_torch.data.nifti import read_nifti

            return np.asarray(read_nifti(path_item), np.float32)
        arr = np.load(path_item)
        if hasattr(arr, "files"):  # npz
            arr = arr[arr.files[0]]
        return np.asarray(arr, np.float32)

    def __getitem__(self, index):
        rel = Path(self.item_pointers[index])
        vol = self.load_item(self.path_root / rel)
        if vol.ndim == 3:
            vol = vol[..., None]  # [D, H, W, 1]
        if self.transform is not None:
            return {"uid": rel.stem, "source": self.transform(vol, self.rng)}
        if self.image_resize is not None:
            vol = resize_volume(vol, self.image_resize)
        if self.flip:
            for axis in range(3):
                if self.rng.random() < 0.5:
                    vol = np.flip(vol, axis=axis)
        if self.image_crop is not None:
            vol = crop_or_pad(vol, self.image_crop)
        if self.use_znorm:
            vol = (vol - vol.mean()) / (vol.std() + 1e-8)
        else:
            lo, hi = vol.min(), vol.max()
            vol = 2 * (vol - lo) / (hi - lo + 1e-8) - 1
        return {"uid": rel.stem, "source": np.ascontiguousarray(vol, np.float32)}
