"""Build and load the butterfly CUDA kernels (``csrc/*.cu``).

Every ``.cu`` source under ``csrc/`` compiles with its own ``nvcc`` for
``sm_90a`` (all started together), and the objects link into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
build happens at first use, into ``build/repro_torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``), or, for an installed
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

__all__ = ["BuildInfo", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "ENTRY_POINTS",
           "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    # <root>/src/repro_torch/kernels/butterfly/build.py in a checkout
    src = Path(__file__).resolve().parents[3]
    if src.name == "src" and (src.parent / "pyproject.toml").is_file():
        return src.parent / "build" / "repro_torch_kernels"
    return Path.home() / ".cache" / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C entry points: (device stack, partials, n_windows, n_rows, n_cols,
# block_i, stream) -> cudaError_t as int
ENTRY_POINTS = ("butterfly_windows_launch", "butterfly_windows_multiset_launch")


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


def _run_all(cmds: list[list[str]]) -> tuple[str, list[str]]:
    """Run every command at once; wait for all.  Returns the joined output
    and the failures, each with its command line and output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    return "".join(logs), failed


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
        # build under private names, then rename: concurrent builds (test
        # workers) never load a half-written library
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        tmp = path.with_suffix(f".{tag}")
        t0 = time.perf_counter()
        try:
            log, failed = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                     str(src)]
                                    for src, o in zip(sources, objs)])
            if not failed:
                link_log, failed = _run_all([[
                    nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(tmp), *map(str, objs)]])
                log += link_log
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("\n".join(failed))
            os.replace(tmp, path)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
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
