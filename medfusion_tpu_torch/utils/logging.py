"""Metrics and image dumps of the training CLIs (port of
``medfusion_tpu/utils/logging.py``).

:class:`MetricsWriter` appends the JAX writer's ``metrics.jsonl`` rows
(``{"step", "time", "train/<name>": value}``). It writes no TensorBoard
events: tensorboard is not installed on the card's machine.
:func:`save_image_grid` writes torchvision ``save_image``'s grid as a PNG
through ``data/png.py``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from medfusion_tpu_torch.data.png import write_png


class MetricsWriter:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = "train") -> None:
        row = {"step": int(step), "time": time.time()}
        for name, val in scalars.items():
            row[f"{prefix}/{name}"] = float(val)
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Min-max normalize to uint8 (torchvision save_image(normalize=True))."""
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return (img * 255).clip(0, 255).astype(np.uint8)


def save_image_grid(images: np.ndarray, path, nrow: Optional[int] = None,
                    normalize: bool = True, padding: int = 2) -> None:
    """[N, H, W, C] -> one PNG grid (torchvision save_image equivalent)."""
    n, h, w, c = images.shape
    nrow = nrow or int(np.ceil(np.sqrt(n)))
    ncol = int(np.ceil(n / nrow))
    grid = np.zeros((ncol * (h + padding) + padding, nrow * (w + padding) + padding, c),
                    np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = r * (h + padding) + padding, col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    arr = to_uint8(grid) if normalize else (grid * 255).clip(0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, arr)
