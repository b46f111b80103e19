"""A NIfTI-1 reader and writer: the 348-byte header, ``.nii.gz``, the
voxels, and ``scl_slope``/``scl_inter`` (port of ``medfusion_tpu/data/nifti.py``).

The reader returns the voxel grid in the file's stored order ([X, Y, Z(, T
or C)], x fastest on disk, as the NIfTI-1.1 ``nifti1.h`` specifies) with the
scaling applied, and ignores the affine: the reference pipelines crop, pad
and resize on the voxel grid and never use it. Single-file ``n+1`` volumes
only; the two-file ``.hdr``/``.img`` form is refused.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

# nifti1.h datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
HEADER_BYTES = 348


def _open(path, mode: str):
    path = Path(path)
    if path.name.lower().endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path, with_header: bool = False):
    """A ``.nii``/``.nii.gz`` volume as a C-contiguous array of shape
    ``dim[1:1 + ndim]``, float32 where the header scales it; with
    ``with_header`` also {'pixdim', 'datatype', 'bitpix', 'byteorder'}."""
    with _open(path, "rb") as f:
        hdr = f.read(HEADER_BYTES)
        if len(hdr) < HEADER_BYTES:
            raise ValueError(f"{path}: truncated NIfTI header ({len(hdr)} bytes)")
        bo = "<"
        sizeof_hdr = struct.unpack("<i", hdr[:4])[0]
        if sizeof_hdr != HEADER_BYTES:
            sizeof_hdr = struct.unpack(">i", hdr[:4])[0]
            if sizeof_hdr != HEADER_BYTES:
                raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
            bo = ">"
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        dim = struct.unpack(f"{bo}8h", hdr[40:56])
        ndim = dim[0]
        if not 1 <= ndim <= 7:
            raise ValueError(f"{path}: bad ndim {ndim}")
        shape = tuple(max(1, d) for d in dim[1:1 + ndim])
        datatype, bitpix = struct.unpack(f"{bo}2h", hdr[70:74])
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
        vox_offset = struct.unpack(f"{bo}f", hdr[108:112])[0]
        scl_slope = struct.unpack(f"{bo}f", hdr[112:116])[0]
        scl_inter = struct.unpack(f"{bo}f", hdr[116:120])[0]
        if magic[:3] == b"ni1":
            raise ValueError(f"{path}: two-file (.hdr/.img) NIfTI not supported")
        skip = int(vox_offset) - HEADER_BYTES
        if skip > 0:
            f.read(skip)
        count = int(np.prod(shape))
        data = f.read(count * np_dtype.itemsize)
        if len(data) < count * np_dtype.itemsize:
            raise ValueError(f"{path}: truncated voxel data")
        arr = np.frombuffer(data, dtype=np_dtype, count=count)
        arr = np.ascontiguousarray(arr.reshape(shape, order="F"))  # x fastest on disk
        if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
            slope = scl_slope if scl_slope != 0.0 else 1.0
            arr = arr.astype(np.float32) * slope + scl_inter
    if with_header:
        pixdim = struct.unpack(f"{bo}8f", hdr[76:108])
        return arr, {"pixdim": pixdim[1:1 + ndim], "datatype": datatype,
                     "bitpix": bitpix, "byteorder": bo}
    return arr


def write_nifti(path, arr: np.ndarray, pixdim: Optional[Tuple[float, ...]] = None,
                scl_slope: float = 1.0, scl_inter: float = 0.0) -> None:
    """Write a single-file little-endian NIfTI-1 without extensions (gzip
    for a ``.gz`` name). A dtype NIfTI has no code for is stored as
    float32; ``scl_slope``/``scl_inter`` go into the header as they are."""
    arr = np.asarray(arr)
    if arr.dtype not in _DTYPE_CODES:
        arr = arr.astype(np.float32)
    ndim = arr.ndim
    if not 1 <= ndim <= 7:
        raise ValueError(f"cannot write {ndim}-d array as NIfTI")
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    pd = [1.0] + list(pixdim or ()) + [1.0] * 7
    hdr = bytearray(HEADER_BYTES)
    struct.pack_into("<i", hdr, 0, HEADER_BYTES)  # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, _DTYPE_CODES[arr.dtype], arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pd[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset: header + extension flag
    struct.pack_into("<f", hdr, 112, scl_slope)
    struct.pack_into("<f", hdr, 116, scl_inter)
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00\x00\x00\x00")  # no extensions
        f.write(np.asfortranarray(arr).tobytes(order="F"))
