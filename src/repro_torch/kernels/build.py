"""Build and load the port's CUDA kernel libraries.

A :class:`KernelLibrary` names a ``csrc/`` directory of ``.cu`` sources and
the C entry points they export, with their ``ctypes`` argument types.  Every
source compiles with its own ``nvcc`` for ``sm_90a``; :func:`load` starts
the ``nvcc`` of every source of every library it is given together, then
links each library's objects into one shared library with a plain C
interface and loads it with ``ctypes``.  The build happens at first use,
into ``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), or, for an installed package, into
``~/.cache/repro_torch_kernels/``; a library's file name carries a hash of
its sources, headers and flags, so an edited source never loads a stale
library.
Nothing here runs at import: the CPU tests import this module on hosts
without ``nvcc``.
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

__all__ = ["BuildInfo", "KernelLibrary", "BUILD_DIR", "NVCC_FLAGS", "load"]


def _build_dir() -> Path:
    # <root>/src/repro_torch/kernels/build.py in a checkout
    src = Path(__file__).resolve().parents[2]
    if src.name == "src" and (src.parent / "pyproject.toml").is_file():
        return src.parent / "build" / "repro_torch_kernels"
    return Path.home() / ".cache" / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class KernelLibrary:
    """One library: its name (the ``.so``'s stem), its source directory and
    its C entry points, each with its ``ctypes`` argument types (every
    entry point returns a ``cudaError_t`` as ``int``)."""

    name: str
    csrc: Path
    entry_points: tuple[tuple[str, tuple], ...]

    def sources(self) -> list[Path]:
        sources = sorted(self.csrc.glob("*.cu"))
        if not sources:
            raise RuntimeError(f"no CUDA sources under {self.csrc}")
        return sources

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources() + sorted(self.csrc.glob("*.cuh")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"


@dataclass(frozen=True)
class BuildInfo:
    """One loaded kernel library: its path, how long ``nvcc`` took (0.0 when
    an existing build of the same sources was reused; the build of several
    libraries started together shares one wall time) and what ``nvcc``
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
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from source at first use")
    return found


def _run_all(cmds: list[list[str]]) -> tuple[list[str], list[str]]:
    """Run every command at once; wait for all.  Returns each command's
    output and the failures, each with its command line and output."""
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
    return logs, failed


def _build(libs: list[KernelLibrary]) -> tuple[float, dict[str, str]]:
    """Compile every source of ``libs`` at once, then link each library.
    Builds under private names and renames after: concurrent builds (test
    workers) never load a half-written library.  Returns the wall seconds
    and each library's ``nvcc`` output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = [(lib, src, BUILD_DIR / f"{lib.name}.{src.stem}.{tag}.o")
            for lib in libs for src in lib.sources()]
    logs = {lib.name: "" for lib in libs}
    t0 = time.perf_counter()
    try:
        outs, failed = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                  str(src)] for _, src, o in jobs])
        for (lib, _, _), out in zip(jobs, outs):
            logs[lib.name] += out
        if not failed:
            links = [[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", "-o", str(lib.path().with_suffix(f".{tag}")),
                      *(str(o) for ll, _, o in jobs if ll is lib)]
                     for lib in libs]
            outs, failed = _run_all(links)
            for lib, out in zip(libs, outs):
                logs[lib.name] += out
        if failed:
            raise RuntimeError("\n".join(failed))
        for lib in libs:
            os.replace(lib.path().with_suffix(f".{tag}"), lib.path())
    finally:
        for _, _, o in jobs:
            o.unlink(missing_ok=True)
        for lib in libs:
            lib.path().with_suffix(f".{tag}").unlink(missing_ok=True)
    return time.perf_counter() - t0, logs


_loaded: dict[str, BuildInfo] = {}


def load(*libs: KernelLibrary) -> list[BuildInfo]:
    """The given libraries, built on the first call in this process that
    names them (every missing one in one parallel build) and cached
    after it."""
    todo = [lib for lib in libs
            if lib.name not in _loaded and not lib.path().exists()]
    seconds, logs = _build(todo) if todo else (0.0, {})
    for lib in libs:
        if lib.name in _loaded:
            continue
        path = lib.path()
        dll = ctypes.CDLL(str(path))
        for name, argtypes in lib.entry_points:
            fn = getattr(dll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[lib.name] = BuildInfo(lib=dll, path=path,
                                      seconds=seconds if lib in todo else 0.0,
                                      log=logs.get(lib.name, ""))
    return [_loaded[lib.name] for lib in libs]
