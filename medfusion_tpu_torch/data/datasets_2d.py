"""2D image datasets (port of ``medfusion_tpu/data/datasets_2d.py``): the
file crawler and the labelled datasets of the presets.

* ``SimpleDataset2D``    — rglob crawler, items {'uid', 'source'}.
* ``AIROGSDataset``      — eye fundus JPEGs, labels from ``train_labels.csv``
  (NRG=0, RG=1), inverse-frequency weights.
* ``MSIvsMSSDataset``   — colon histology, label from the parent
  directory's name (MSIMUT=0, MSS=1), with the item's ``uid``.
* ``MSIvsMSS_2_Dataset`` — colon histology, label from the parent
  directory's name (MSIH=0, nonMSIH=1).
* ``CheXpertDataset``    — the CheXpert release's own CSV
  (``<root.parent>/<root.name>.csv``): its frontal rows, the path's first
  20 characters (``CheXpert-v1.0-small/``) cut, Cardiomegaly -1 / 0 / 1 /
  empty as the labels 0 / 1 / 2 / 3, with the item's ``uid``.
* ``CheXpert_2_Dataset`` — the flagship chest dataset: PNGs under
  ``data/``, labels from a join of two CSV files, Cardiomegaly with NaN
  and < 0 mapped to 2, inverse-frequency weights.

The CSV files are read with the ``csv`` module (the JAX package uses
pandas) in the same row order, with the same filters and the same join.
Images are read by ``data/png.py`` (PNG) or PIL (any other format) and
converted to RGB. Items are channels-last float32 numpy arrays in [-1, 1];
each item's flips draw from the dataset's one ``rng``, in the order the
items are read. No preset uses ``MSIvsMSSDataset`` or ``CheXpertDataset``.
"""

from __future__ import annotations

import csv
import math
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from medfusion_tpu_torch.data.png import read_rgb
from medfusion_tpu_torch.data.transforms import Compose2D


def _read_csv(path: Path) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _float(value: str) -> float:
    """A pandas numeric cell: an empty cell is NaN."""
    return math.nan if value.strip() == "" else float(value)


class SimpleDataset2D:
    def __init__(
        self,
        path_root,
        item_pointers: Sequence = (),
        crawler_ext: str = "tif",
        transform: Optional[Callable] = None,
        image_resize=None,
        augment_horizontal_flip: bool = False,
        augment_vertical_flip: bool = False,
        image_crop=None,
        seed: int = 0,
    ):
        self.path_root = Path(path_root)
        self.crawler_ext = crawler_ext
        self.rng = np.random.default_rng(seed)
        if len(item_pointers):
            self.item_pointers = list(item_pointers)
        else:
            self.item_pointers = self.run_item_crawler(self.path_root, crawler_ext)
        self.transform = transform or Compose2D(
            image_resize=image_resize,
            augment_horizontal_flip=augment_horizontal_flip,
            augment_vertical_flip=augment_vertical_flip,
            image_crop=image_crop,
        )

    def __len__(self):
        return len(self.item_pointers)

    def __getitem__(self, index):
        rel = Path(self.item_pointers[index])
        img = self.load_item(self.path_root / rel)
        return {"uid": rel.stem, "source": self.transform(img, self.rng)}

    def load_item(self, path_item) -> np.ndarray:
        return read_rgb(path_item)

    @classmethod
    def run_item_crawler(cls, path_root, extension, **kwargs) -> List[Path]:
        return sorted(p.relative_to(path_root) for p in Path(path_root).rglob(f"*.{extension}"))

    def get_weights(self) -> Optional[List[float]]:
        """Per-item weights for weighted sampling; None = uniform."""
        return None


def _inverse_frequency_weights(values) -> List[float]:
    """1 / (the value's share of the non-NaN values), per value: pandas'
    ``1.0 / Series.value_counts(normalize=True)``, whose share is the count
    over the counts' sum."""
    counts = Counter(v for v in values if not (isinstance(v, float) and math.isnan(v)))
    total = sum(counts.values())
    return [float(1.0 / (counts[v] / total)) for v in values]


class AIROGSDataset(SimpleDataset2D):
    STR_2_INT = {"NRG": 0, "RG": 1}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        rows = _read_csv(self.path_root.parent / "train_labels.csv")
        self.uids = [r["challenge_id"] for r in rows]
        self.classes = [r["class"] for r in rows]

    def __len__(self):
        return len(self.uids)

    def __getitem__(self, index):
        img = self.load_item(self.path_root / f"{self.uids[index]}.jpg")
        target = self.STR_2_INT[self.classes[index]]
        return {"source": self.transform(img, self.rng), "target": target}

    def get_weights(self):
        return _inverse_frequency_weights(self.classes)

    @classmethod
    def run_item_crawler(cls, path_root, extension, **kwargs):
        return []


class MSIvsMSSDataset(SimpleDataset2D):
    STR_2_INT = {"MSIMUT": 0, "MSS": 1}

    def __getitem__(self, index):
        rel = Path(self.item_pointers[index])
        img = self.load_item(self.path_root / rel)
        target = self.STR_2_INT[(self.path_root / rel).parent.name]
        return {"uid": rel.stem, "source": self.transform(img, self.rng), "target": target}


class MSIvsMSS_2_Dataset(SimpleDataset2D):
    STR_2_INT = {"MSIH": 0, "nonMSIH": 1}

    def __getitem__(self, index):
        rel = Path(self.item_pointers[index])
        img = self.load_item(self.path_root / rel)
        target = self.STR_2_INT[(self.path_root / rel).parent.name]
        return {"source": self.transform(img, self.rng), "target": target}


class CheXpertDataset(SimpleDataset2D):
    """The rows of ``<root.parent>/<root.name>.csv`` whose ``Frontal/Lateral``
    is ``Frontal``, in file order; item i reads ``root / Path[20:]``, and its
    target is Cardiomegaly + 1 with an empty cell read as 2 (pandas'
    ``fillna(2)``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        rows = _read_csv(self.path_root.parent / f"{self.path_root.name}.csv")
        frontal = [r for r in rows if r["Frontal/Lateral"] == "Frontal"]
        self.paths = [r["Path"][20:] for r in frontal]
        cardio = (_float(r["Cardiomegaly"]) for r in frontal)
        self.targets = [int((2.0 if math.isnan(v) else v) + 1) for v in cardio]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        rel = self.paths[index]
        img = self.load_item(self.path_root / rel)
        return {"uid": rel, "source": self.transform(img, self.rng),
                "target": self.targets[index]}

    @classmethod
    def run_item_crawler(cls, path_root, extension, **kwargs):
        return []


class CheXpert_2_Dataset(SimpleDataset2D):
    """The preprocessed-CSV CheXpert variant (the flagship training set).

    ``labels/cheXPert_label.csv`` rows with ``fold == "train"``, in file
    order, left-joined on ``Path`` with the ``Frontal`` rows of
    ``labels/train.csv``, whose Cardiomegaly is set to 2 where it is NaN or
    < 0. Item i reads ``data/<Image Index:06>.png``. As in the JAX package,
    when the first file has a Cardiomegaly column of its own, that column is
    the target (the join's column is then ``Cardiomegaly_true``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        labels = [r for r in _read_csv(self.path_root / "labels/cheXPert_label.csv")
                  if r["fold"] == "train"]
        truth: Dict[str, List[float]] = {}
        for r in _read_csv(self.path_root / "labels/train.csv"):
            if r["Frontal/Lateral"] == "Frontal":
                v = _float(r["Cardiomegaly"])
                truth.setdefault(r["Path"], []).append(2.0 if math.isnan(v) or v < 0 else v)
        own = bool(labels) and "Cardiomegaly" in labels[0]
        self.image_index: List[int] = []
        self.targets: List[float] = []
        for r in labels:
            # a left join: one row per match, or one row with NaN
            for v in truth.get(r["Path"], [math.nan]):
                self.image_index.append(int(r["Image Index"]))
                self.targets.append(_float(r["Cardiomegaly"]) if own else v)

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, index):
        img = self.load_item(self.path_root / "data" / f"{self.image_index[index]:06}.png")
        target = int(self.targets[index])
        return {"source": self.transform(img, self.rng), "target": target}

    def get_weights(self):
        return _inverse_frequency_weights(self.targets)

    @classmethod
    def run_item_crawler(cls, path_root, extension, **kwargs):
        return []
