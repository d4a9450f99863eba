"""K3 and K4 on Hopper: the int32 prefix sum and the stream compaction as
CUDA kernels written by hand.

Replace the JAX package's ``kernels/compact.py:prefix_sum`` (a Pallas MXU
scan with a scalar carry down a sequential grid) and ``stream_compact`` (that
scan, then K1 over the positions). The kernels are ``csrc/compact.cu``; its
header says what bounds them and how the design answers that. They compute:

    prefix_sum(x)[i] = x[0] + ... + x[i]                      (int32 out)
    stream_compact(values, live, out_size=S, fill=f):
        out = full(S, f); out[cumsum(live) - 1] = values[live]  (extra drop)

Both are one pass with decoupled look-back over ticketed tiles (8,192 lanes
for K3, 4,096 for K4): one memset of their tile status words, then one
kernel launch, counted once a call in ``prefix_sum_launches`` and
``stream_compact_launches``. ``stream_compact`` does not call
``prefix_sum``. Both sum in int32, so they are exact at any size; the JAX
kernels sum in float32 and are exact below 2^24, where the two give the
same arrays. Survivors keep their lane order.

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
stream_compact_launches = 0  # K4 calls that launched the kernel
TILE = 4096  # lanes a K4 tile (a K3 tile is twice it, csrc/compact.cu); one 8-byte
             # status word a tile, so K3's words fit K4's count
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
    lib.scan_ceiling_u8.argtypes = [p, ll, p, p, p]
    lib.scan_ceiling_u8.restype = i
    lib.stream_compact_i32.argtypes = [p, i, p, ll, ll, i, p, p, p]
    lib.stream_compact_i32.restype = i
    lib.compact_tile_lanes.restype = i
    if lib.compact_tile_lanes() != TILE:
        raise RuntimeError(f"{SOURCE.name} has tiles of {lib.compact_tile_lanes()} lanes, "
                           f"its wrapper {TILE}")
    _lib = lib
    return lib


def _check_cuda(*tensors: torch.Tensor) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"no compaction kernel for {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the compaction kernels need contiguous tensors")
    if tensors[0].shape[0] >= 2**31:
        raise ValueError("the compaction kernels index lanes in int32")


def _with_status(n: int, size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """One int32 allocation: the tile status words of an ``n``-lane pass (one
    a tile and the ticket, 8 bytes each, padded to 256 bytes), then ``size``
    ints of output. Returns (the whole buffer, the output view)."""
    head = (2 * (-(-n // TILE) + 1) + 63) // 64 * 64
    buf = torch.empty(head + size, dtype=torch.int32, device=device)
    return buf, buf[head:]


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D bool or int32 tensor, int32 out.

    On a CPU tensor this is ``ref.prefix_sum_ref``; on a CUDA tensor one call
    of the one-pass kernel (a memset of its status words, then one launch),
    counted in ``prefix_sum_launches``. The output and the status words come
    from one allocation (``out`` is a view of it).
    """
    global prefix_sum_launches
    if x.dim() != 1 or x.dtype not in _SCAN_ENTRY:
        raise TypeError(f"prefix_sum takes a 1-D bool or int32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return prefix_sum_ref(x)
    _check_cuda(x)
    n = x.shape[0]
    buf, out = _with_status(n, n, x.device)
    if n == 0:
        return out
    lib = _lib or load_library()
    err = build.on_device(x.device, getattr(lib, _SCAN_ENTRY[x.dtype]), x.data_ptr(), n,
                          out.data_ptr(), buf.data_ptr())
    if err:
        raise build.launch_error(lib, "compact_error_string", err, "prefix-sum kernel")
    prefix_sum_launches += 1
    return out


def scan_ceiling(x: torch.Tensor) -> torch.Tensor:
    """A diagnostic, not a scan: K3's pass over a 1-D bool CUDA tensor with
    no look-back, so each 8,192-lane tile holds its own inclusive sums. The
    same memset, loads and stores as ``prefix_sum``, so its time beside
    K3's is what the look-back costs. Not counted in ``prefix_sum_launches``
    and used by no path."""
    if x.dim() != 1 or x.dtype != torch.bool:
        raise TypeError(f"scan_ceiling takes a 1-D bool tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    _check_cuda(x)
    buf, out = _with_status(x.shape[0], x.shape[0], x.device)
    lib = _lib or load_library()
    err = build.on_device(x.device, lib.scan_ceiling_u8, x.data_ptr(), x.shape[0],
                          out.data_ptr(), buf.data_ptr())
    if err:
        raise build.launch_error(lib, "compact_error_string", err, "scan ceiling")
    return out


def stream_compact(
    values: torch.Tensor, live: torch.Tensor, *, out_size: int, fill: int,
) -> torch.Tensor:
    """Compact ``values[live]`` into a dense ``[out_size]`` (or
    ``[out_size, D]``) int32 tensor, empty slots ``fill``; survivors past
    ``out_size`` drop. ``values`` is int32 ``[E]`` or ``[E, D]``, ``live``
    bool ``[E]``.

    On a CPU tensor this is ``ref.stream_compact_ref``; on a CUDA tensor one
    call of the one-pass kernel (a memset of its status words, then one
    launch), counted in ``stream_compact_launches``. The output and the
    kernel's status words come from one allocation (``out`` is a view of it).
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
    n, d = values.shape[0], 1 if values.dim() == 1 else values.shape[1]
    buf, out = _with_status(n, out_size * d, values.device)
    out = out.view((out_size,) + tuple(values.shape[1:]))
    if out.numel() == 0:
        return out
    lib = _lib or load_library()
    err = build.on_device(values.device, lib.stream_compact_i32, values.data_ptr(), d,
                          live.data_ptr(), n, out_size, int(fill), out.data_ptr(),
                          buf.data_ptr())
    if err:
        raise build.launch_error(lib, "compact_error_string", err,
                                 "stream-compaction kernel")
    stream_compact_launches += 1
    return out


__all__ = ["prefix_sum", "stream_compact", "scan_ceiling", "load_library", "SOURCE"]
