"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
one shared library (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``); all sources compile in parallel, one ``nvcc``
each. Libraries land in ``medfusion_tpu_torch/_build/`` under a name that
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. A failed build raises with the compiler's output. One lock
serialises the builds and loads, so threads that launch their first kernels
at once (a server's worker and handler threads) run one ``nvcc`` a source,
not one each into the same temporary file; an exclusive ``flock`` on the
build directory does the same across processes (the ranks of a
``torchrun`` job on one host): the first to take it compiles, the others
find its libraries when they take it in turn. :data:`LAUNCH_LOCK` guards the
wrappers' launch counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}  # stem -> compiler output (ptxas register use)
BUILD_SECONDS: Dict[str, float] = {}  # stem -> seconds from the builds' start to its end
_BUILD_LOCK = threading.RLock()  # build_all and the loads in library/function
# Held by each wrapper around its ``LAUNCHES += 1`` (a read-modify-write of a
# module global) and by ``ops.reset_launch_counts``, so counts taken while
# several threads launch are exact.
LAUNCH_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(src.read_bytes() + headers
                     + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{h[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all at
    once, under the build lock of this process and of the build directory.
    Returns stem -> library path."""
    with _BUILD_LOCK, _directory_lock():
        return _build_all()


@contextlib.contextmanager
def _directory_lock():
    """An exclusive ``flock`` on :data:`BUILD_DIR` (a lock on the directory
    itself, so it adds no file; the kernel drops it when its holder exits)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd = os.open(BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing the descriptor releases the lock


def _build_all() -> Dict[str, Path]:
    sources = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    pending = {}
    start = time.perf_counter()
    for src in sources:
        out = targets[src.stem]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        pending[src.stem] = (proc, tmp, log, out)
    failures = []
    while pending:  # poll, so that each library's seconds are its own
        for stem, (proc, tmp, log, out) in list(pending.items()):
            if proc.poll() is None:
                continue
            BUILD_SECONDS[stem] = time.perf_counter() - start
            BUILD_LOG[stem] = log.read_text()
            log.unlink()
            del pending[stem]
            if proc.returncode != 0:
                failures.append(f"{stem}.cu (exit {proc.returncode}):\n{BUILD_LOG[stem]}")
                continue
            os.replace(tmp, out)
        time.sleep(0.05)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _LIBS.get(stem)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIBS.get(stem)
            if lib is None:
                targets = build_all()
                if stem not in targets:
                    raise RuntimeError(f"no kernel source csrc/{stem}.cu")
                lib = _LIBS[stem] = ctypes.CDLL(str(targets[stem]))
    return lib


def function(stem: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<stem>.cu``, returning an
    int CUDA error code, with its argument types set once."""
    fn = _FNS.get(symbol)
    if fn is None:
        with _BUILD_LOCK:
            fn = _FNS.get(symbol)
            if fn is None:
                fn = getattr(library(stem), symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FNS[symbol] = fn
    return fn
