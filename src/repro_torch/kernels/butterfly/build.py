"""Build and load the butterfly CUDA kernels (``csrc/*.cu``).

Every ``.cu`` source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, which is loaded with
``ctypes``.  The build happens at first use, into ``build/repro_torch_kernels/``
at the root of the checkout (listed in ``.gitignore``), or, for an installed
package, into ``~/.cache/repro_torch_kernels/``; the library's file name
carries a hash of the sources and flags, so an edited source never loads a
stale library.  Nothing here runs at import: the CPU tests import
this module on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BuildInfo", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    # <root>/src/repro_torch/kernels/butterfly/build.py in a checkout
    src = Path(__file__).resolve().parents[3]
    if src.name == "src" and (src.parent / "pyproject.toml").is_file():
        return src.parent / "build" / "repro_torch_kernels"
    return Path.home() / ".cache" / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    """One loaded kernel library: its path, how long ``nvcc`` took (0.0 when
    an existing build of the same sources was reused) and what ``nvcc``
    printed (``-Xptxas -v``: registers, shared memory and spills per
    kernel)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "butterfly CUDA kernels are built from source at first use")
    return found


def _build() -> BuildInfo:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"libbutterfly_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent builds (test
        # workers) never load a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    fn = lib.butterfly_windows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return BuildInfo(lib=lib, path=path, seconds=seconds, log=log)


_loaded: BuildInfo | None = None


def load_library() -> BuildInfo:
    """The kernel library, built on the first call in this process and
    cached after it."""
    global _loaded
    if _loaded is None:
        _loaded = _build()
    return _loaded
