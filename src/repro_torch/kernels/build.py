"""Building the hand-written CUDA sources of ``csrc/`` at first use.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, ``csrc/build/<stem>-<hash>.so``, keyed on a hash
of the source, the shared headers ``csrc/*.cuh`` and the flags (so an edit
rebuilds), and loaded with ``ctypes``. A failed build raises with nvcc's
output; nothing falls back.

``build_all`` starts one ``nvcc`` per source at once and waits for all of
them, so a first use that needs several kernels pays for the slowest build,
not the sum.

A library load is what this package builds at run time, so it is what the
recompile auditor (``obs/audit.py``) counts, under its ``"kernels"``
provider: the libraries loaded so far, and the CUDA-graph captures that
register in ``GRAPH_CAPTURES`` (none yet).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from repro_torch.obs.audit import AUDITOR

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

build_logs: dict[str, str] = {}  # nvcc/ptxas output of builds made by this process
_libs: dict[Path, ctypes.CDLL] = {}
# objects with ``_cache_size()`` and ``__name__``, one per CUDA-graph
# capture site, for the auditor; no path captures a graph yet
GRAPH_CAPTURES: list = []


class _LoadedLibraries:
    """The auditor's view of ``load``: one cache whose size is the number of
    kernel libraries this process has loaded."""

    __name__ = "load"

    @staticmethod
    def _cache_size() -> int:
        return len(_libs)


_LOADED = _LoadedLibraries()  # one object: the auditor keys sizes by identity


def _audited() -> list:
    return [_LOADED] + list(GRAPH_CAPTURES)


AUDITOR.register_provider(_audited, name="kernels")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: building the port's kernels "
                           "needs nvcc (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    # the shared headers of csrc/ are part of every source's key
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}.so"


def build_all(sources: list[Path]) -> None:
    """Compile every source whose library is missing, all at once."""
    pending = []
    for source in sources:
        so = library_path(source)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.so"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        pending.append((source, so, tmp, proc))
    failed = []
    for source, so, tmp, proc in pending:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {source.name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
        build_logs[source.name] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        build_all([source])
        lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
    return lib


def on_device(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current CUDA stream with
    ``device`` current: a C entry point's launch. Enters
    ``torch.cuda.device`` only when another device is current, and reads
    the raw stream pointer without building a ``torch.cuda.Stream``: both
    cost more host time than a small kernel takes on the card. Returns what
    ``fn`` returns, a CUDA error code."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return fn(*args, _raw_stream(index))
    return fn(*args, _raw_stream(index))


def _raw_stream(index: int) -> int:
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # PyTorch's own launchers use it
    return get(index) if get else torch.cuda.current_stream(index).cuda_stream


def launch_error(lib: ctypes.CDLL, strerror: str, err: int, what: str) -> RuntimeError:
    """The exception for a C entry point that returned CUDA error ``err``;
    ``strerror`` names the library's wrapper of ``cudaGetErrorString``."""
    fn = getattr(lib, strerror)
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return RuntimeError(f"{what} launch failed: {fn(err).decode()} ({err})")


__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "GRAPH_CAPTURES", "build_logs", "build_all", "load",
           "library_path", "on_device", "launch_error"]
