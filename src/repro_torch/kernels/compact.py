"""K3 and K4 on Hopper: the int32 prefix sum and the stream compaction as
CUDA kernels written by hand.

Replace the JAX package's ``kernels/compact.py:prefix_sum`` (a Pallas MXU
scan with a scalar carry down a sequential grid) and ``stream_compact`` (that
scan, then K1 over the positions). The kernels are ``csrc/compact.cu``; its
header says what bounds them and how the design answers that. They compute:

    prefix_sum(x)[i] = x[0] + ... + x[i]                      (int32 out)
    stream_compact(values, live, out_size=S, fill=f):
        out = full(S, f); out[cumsum(live) - 1] = values[live]  (extra drop)

``stream_compact`` is ``prefix_sum`` of the mask (one K3 call, counted in
``prefix_sum_launches``) followed by the scatter kernel (counted in
``stream_compact_launches``). Both sum in int32, so they are exact at any
size; the JAX kernels sum in float32 and are exact below 2^24, where the two
give the same arrays. Survivors keep their lane order.

On a CPU tensor each wrapper runs its plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises. The source is built at first use
by ``kernels/build.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import prefix_sum_ref, stream_compact_ref

SOURCE = build.CSRC / "compact.cu"

prefix_sum_launches = 0      # K3 calls that launched the kernel
stream_compact_launches = 0  # K4 scatter launches (each after one K3 call)
_lib: ctypes.CDLL | None = None
_SCAN_ENTRY = {torch.bool: "prefix_sum_u8", torch.int32: "prefix_sum_i32"}


def load_library() -> ctypes.CDLL:
    """Build the kernel library if this source was not built yet, load it
    and declare its C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in _SCAN_ENTRY.values():
        getattr(lib, name).argtypes = [p, ll, p, p, p]
        getattr(lib, name).restype = i
    lib.stream_compact_i32.argtypes = [p, i, p, p, ll, ll, i, p, p]
    lib.stream_compact_i32.restype = i
    lib.compact_scratch_ints.argtypes = [ll]
    lib.compact_scratch_ints.restype = ll
    _lib = lib
    return lib


def _check_cuda(*tensors: torch.Tensor) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"no compaction kernel for {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the compaction kernels need contiguous tensors")
    if tensors[0].shape[0] >= 2**31:
        raise ValueError("the compaction kernels index lanes in int32")


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D bool or int32 tensor, int32 out.

    On a CPU tensor this is ``ref.prefix_sum_ref``; on a CUDA tensor one call
    of the kernel (three CUDA launches: tile sums, their scan, the tile
    scans), counted once in ``prefix_sum_launches``.
    """
    global prefix_sum_launches
    if x.dim() != 1 or x.dtype not in _SCAN_ENTRY:
        raise TypeError(f"prefix_sum takes a 1-D bool or int32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return prefix_sum_ref(x)
    _check_cuda(x)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.shape[0] == 0:
        return out
    lib = load_library()
    scratch = torch.empty(lib.compact_scratch_ints(x.shape[0]), dtype=torch.int32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _SCAN_ENTRY[x.dtype])(x.data_ptr(), x.shape[0],
                                                 out.data_ptr(), scratch.data_ptr(),
                                                 stream)
    if err:
        raise build.launch_error(lib, "compact_error_string", err, "prefix-sum kernel")
    prefix_sum_launches += 1
    return out


def stream_compact(
    values: torch.Tensor, live: torch.Tensor, *, out_size: int, fill: int,
) -> torch.Tensor:
    """Compact ``values[live]`` into a dense ``[out_size]`` (or
    ``[out_size, D]``) int32 tensor, empty slots ``fill``; survivors past
    ``out_size`` drop. ``values`` is int32 ``[E]`` or ``[E, D]``, ``live``
    bool ``[E]``.

    On a CPU tensor this is ``ref.stream_compact_ref``; on a CUDA tensor one
    ``prefix_sum`` of ``live`` and one launch of the scatter kernel, counted
    in ``stream_compact_launches``.
    """
    global stream_compact_launches
    if values.dtype != torch.int32 or values.dim() not in (1, 2):
        raise TypeError(f"stream_compact takes int32 [E] or [E, D] values, got "
                        f"{values.dtype} {tuple(values.shape)}")
    if live.dtype != torch.bool or live.shape != values.shape[:1]:
        raise TypeError(f"stream_compact needs a bool [E] mask, got {live.dtype} "
                        f"{tuple(live.shape)} for values {tuple(values.shape)}")
    if values.device != live.device:
        raise ValueError(f"values on {values.device}, live on {live.device}")
    if not -2**31 <= fill < 2**31:
        raise ValueError(f"fill {fill} is not an int32")
    out_size = int(out_size)
    if values.device.type == "cpu":
        return stream_compact_ref(values, live, out_size, fill)
    _check_cuda(values, live)
    d = 1 if values.dim() == 1 else values.shape[1]
    out = torch.empty((out_size,) + tuple(values.shape[1:]), dtype=torch.int32,
                      device=values.device)
    if out.numel() == 0:
        return out
    pos = prefix_sum(live)
    lib = load_library()
    n = values.shape[0]
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stream_compact_i32(values.data_ptr(), d, live.data_ptr(),
                                     pos.data_ptr() if n else None, n, out_size,
                                     int(fill), out.data_ptr(), stream)
    if err:
        raise build.launch_error(lib, "compact_error_string", err,
                                 "stream-compaction kernel")
    stream_compact_launches += 1
    return out


__all__ = ["prefix_sum", "stream_compact", "load_library", "SOURCE"]
