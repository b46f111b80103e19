"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
one shared library (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``); all sources compile in parallel, one ``nvcc``
each. Libraries land in ``medfusion_tpu_torch/_build/`` under a name that
carries a hash of the source and the flags, so an edited source rebuilds and
an unchanged one is reused. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # stem -> compiler output (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{h[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all at
    once. Returns stem -> library path."""
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s.stem: _target(s) for s in sources}
    pending = {}
    for src in sources:
        out = targets[src.stem]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        pending[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failures = []
    for stem, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        BUILD_LOG[stem] = log
        if proc.returncode != 0:
            failures.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _LIBS.get(stem)
    if lib is None:
        targets = build_all()
        if stem not in targets:
            raise RuntimeError(f"no kernel source csrc/{stem}.cu")
        lib = _LIBS[stem] = ctypes.CDLL(str(targets[stem]))
    return lib
