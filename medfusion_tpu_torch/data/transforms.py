"""Image transforms on numpy arrays, channels-last (port of
``medfusion_tpu/data/transforms.py``).

The reference's default pipeline: Resize -> RandomHorizontalFlip ->
RandomVerticalFlip -> CenterCrop -> [0, 1] -> [-1, 1], plus the auxiliary
2D augmentations (min-max normalisation, random background fill). Images are uint8 [H, W, C] arrays (the JAX package passes PIL
images); randomness comes from the caller's ``np.random.Generator``.

:func:`resize` is a numpy copy of PIL's ``Image.resize(..., BILINEAR)`` on
8-bit images, which the JAX package calls: the same coefficients (a
triangle filter widened by the downscale factor), rounded to 22-bit fixed
point, a horizontal pass into a uint8 image, then a vertical pass.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for the bilinear filter and the whole
    image as the box, normalised to fixed point: (first source index
    [out], fixed-point weights [out, taps]), taps past a row's end 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.intp)
    weights = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(k)
        if ww != 0.0:
            k = [v / ww for v in k]
        first[xx] = xmin
        # every bilinear weight is >= 0: int(0.5 + w * 2^22)
        weights[xx, :xmax] = [int(0.5 + v * (1 << PRECISION_BITS)) for v in k]
    return first, weights


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL pass along ``axis`` of uint8 ``arr``. The sums fit in int32,
    as in PIL: the weights of an output sum to about 2^22, times 255."""
    first, weights = _coefficients(arr.shape[axis], out_size)
    x = np.moveaxis(arr, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + x.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    last = x.shape[0] - 1
    for tap in range(weights.shape[1]):
        w = weights[:, tap].reshape((-1,) + (1,) * (x.ndim - 1))
        acc += x[np.minimum(first + tap, last)] * w
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """torchvision ``T.Resize`` semantics on uint8 [H, W, C]: an int
    resizes the shorter side, keeping the aspect; a pair is (H, W). The
    values are PIL's bilinear resampling."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        size = (int(round(h * size / w)), size) if w < h else (size, int(round(w * size / h)))
    th, tw = size
    out = np.asarray(img)
    if out.ndim == 3 and out.shape[2] > 1 and (out == out[:, :, :1]).all():
        # grey replicated to RGB: the channels resample alike, so resample one
        return np.repeat(resize(out[:, :, :1], (th, tw)), out.shape[2], axis=2)
    if tw != w:
        out = _resample_axis(out, tw, 1)
    if th != h:
        out = _resample_axis(out, th, 0)
    return out


def center_crop(arr: np.ndarray, size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """[H, W, C]; pads with zeros when the crop exceeds the image (torchvision)."""
    th, tw = (size, size) if isinstance(size, int) else size
    h, w = arr.shape[:2]
    if th > h or tw > w:
        out = np.zeros((max(th, h), max(tw, w), arr.shape[2]), arr.dtype)
        y0, x0 = (out.shape[0] - h) // 2, (out.shape[1] - w) // 2
        out[y0:y0 + h, x0:x0 + w] = arr
        arr, (h, w) = out, out.shape[:2]
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return arr[y0:y0 + th, x0:x0 + tw]


def to_array(img: np.ndarray) -> np.ndarray:
    """uint8 or uint16 [H, W(, C)] -> float32 [H, W, C] in [0, 1]
    (T.ToTensor, but channels-last)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def to_array_16bit(img) -> np.ndarray:
    """augmentations_2d.ToTensor16bit: an int32 copy with a channel axis
    [H, W, C], not scaled."""
    arr = np.array(img, np.int32, copy=True)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def normalize_minmax(arr: np.ndarray) -> np.ndarray:
    """augmentations_2d.Normalize: min-max rescale to [0, 1], float32."""
    arr = arr.astype(np.float32)
    lo, hi = arr.min(), arr.max()
    return (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)


def random_background(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """augmentations_2d.RandomBackground: zero pixels -> uniform noise."""
    out = arr.copy()
    mask = out == 0
    out[mask] = rng.random(int(mask.sum()), dtype=np.float32)
    return out


class Compose2D:
    """The reference default transform as one callable(img, rng) -> [H,W,C]
    float32 in [-1, 1]; each enabled flip is one ``rng.random() < 0.5``
    draw, horizontal first."""

    def __init__(
        self,
        image_resize: Optional[Union[int, Tuple[int, int]]] = None,
        augment_horizontal_flip: bool = False,
        augment_vertical_flip: bool = False,
        image_crop: Optional[Union[int, Tuple[int, int]]] = None,
        extra: Sequence[Callable] = (),
    ):
        self.image_resize = image_resize
        self.augment_horizontal_flip = augment_horizontal_flip
        self.augment_vertical_flip = augment_vertical_flip
        self.image_crop = image_crop
        self.extra = tuple(extra)

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if self.image_resize is not None:
            img = resize(img, self.image_resize)
        arr = to_array(img)
        if self.augment_horizontal_flip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        if self.augment_vertical_flip and rng.random() < 0.5:
            arr = arr[::-1]
        if self.image_crop is not None:
            arr = center_crop(arr, self.image_crop)
        arr = (arr - 0.5) / 0.5
        for fn in self.extra:
            arr = fn(arr)
        return np.ascontiguousarray(arr, np.float32)
