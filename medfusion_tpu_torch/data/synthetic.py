"""In-memory synthetic dataset (a copy of
``medfusion_tpu/data/synthetic.py``, numpy only), so that training runs
without data on disk."""

from __future__ import annotations

from typing import Optional

import numpy as np


class SyntheticDataset2D:
    """Class-conditional gaussian-blob images in [-1, 1], channels-last.
    Label k places a bright blob in quadrant k, so the classes are
    distinguishable."""

    def __init__(self, n: int = 64, image_size: int = 64, channels: int = 3,
                 num_classes: Optional[int] = 2, seed: int = 0):
        self.n = n
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.rng = np.random.default_rng(seed)
        self._targets = (self.rng.integers(0, num_classes, n) if num_classes else None)

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        s, c = self.image_size, self.channels
        rng = np.random.default_rng(index * 7919 + 17)
        img = rng.normal(0.0, 0.1, (s, s, c)).astype(np.float32)
        item = {"uid": f"synthetic_{index}"}
        if self._targets is not None:
            k = int(self._targets[index])
            ys = np.arange(s)[:, None]
            xs = np.arange(s)[None, :]
            cy = s // 4 if k % 2 == 0 else 3 * s // 4
            cx = s // 4 if (k // 2) % 2 == 0 else 3 * s // 4
            blob = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * (s / 8) ** 2))
            img += blob[:, :, None].astype(np.float32)
            item["target"] = k
        item["source"] = np.clip(img, -1, 1)
        return item

    def get_weights(self):
        return None
