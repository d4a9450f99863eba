"""K1 on Hopper: the sorted segment-sum as a CUDA kernel written by hand.

Replaces the JAX package's ``kernels/segsum.py:segment_sum_sorted`` (a
one-hot MXU grid on the TPU). The kernel is ``csrc/segsum.cu`` on the
one-pass segmented-reduction core ``csrc/seg_reduce.cuh``; their headers
say what bounds it and how the design answers that. It computes exactly
K1's function:

    out[v, :] = sum over e with seg_ids[e] == v of values[e, :]

for ``seg_ids`` sorted ascending, with ids outside ``[0, num_segments)``
dropped. Sortedness is a precondition of the kernel, not a hint: unsorted
ids give wrong sums on the card (``ops.segment_sum(presorted=False)`` sorts
first).

The source is built at first use by ``kernels/build.py`` (``nvcc`` for
``sm_90a``, a hash-keyed library under ``csrc/build/``, loaded with
``ctypes``). A failed build raises with nvcc's output; a failed launch
raises with the CUDA error. A CUDA tensor never falls back to the plain
version, which runs only for tensors on the CPU; there unsorted ids raise
``ValueError``, so an unsorted hand-off fails in the CPU tests too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_sum_ref, segment_sum_rows_ref

SOURCE = build.CSRC / "segsum.cu"

# Input types each accumulator takes. float32 sums take what the JAX kernel
# takes (converted here, in one pass); int32 sums take 0/1 or integer lanes,
# bools read as one byte with no conversion pass.
_ACCEPTS = {
    torch.float32: (torch.float32, torch.bfloat16, torch.int32, torch.bool),
    torch.int32: (torch.int32, torch.bool),
}
_ENTRY = {torch.float32: "segsum_sorted_f32", torch.int32: "segsum_sorted_i32",
          torch.bool: "segsum_sorted_u8"}

launches = 0       # segment_sum_sorted launches, counted where the kernel is launched
rows_launches = 0  # segment_sum_rows_sorted launches (one for a whole group of rows)
_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build the kernel library if this source was not built yet, load it
    and declare its C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load(SOURCE)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("segsum_rows_i32", "segsum_rows_u8"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.segsum_scratch_ints.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
    lib.segsum_scratch_ints.restype = ctypes.c_longlong
    _lib = lib
    return lib


def segment_sum_sorted(
    values: torch.Tensor,
    seg_ids: torch.Tensor,
    *,
    num_segments: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Segment-sum for lanes **sorted by seg_ids**.

    Args:
      values:   [E] or [E, D]; bool, int32, bfloat16 or float32 for float32
                sums, bool or int32 for int32 sums.
      seg_ids:  [E] int32, ascending; ids outside [0, num_segments) dropped.
      num_segments: output rows V.
      out_dtype: the accumulator and output type, float32 (the JAX kernel's)
                or int32 (exact integer counts at any size).

    Returns [V] (for 1-D values) or [V, D] of ``out_dtype``. Values that
    require a gradient raise ``NotImplementedError`` under grad mode, on
    every device: the kernel has no backward. On a CPU tensor
    this is the plain version (``ref.segment_sum_ref``), after a check that
    the ids ascend (``ValueError`` if not); on a CUDA tensor it is one call
    of the kernel, counted once in ``launches`` (for 1-D values a memset and
    one pass over the lanes, plus a short carry launch for float32 sums; for
    [E, D] values one pass of blocks over spans of lane tiles staged by bulk
    copies, which also zeroes the rows with no lanes, and a short carry
    launch that adds the rows crossing spans).
    """
    global launches
    accepted = _ACCEPTS.get(out_dtype)
    if accepted is None:
        raise TypeError(f"out_dtype must be float32 or int32, got {out_dtype}")
    if values.dtype not in accepted:
        raise TypeError(f"{out_dtype} segment sums take {accepted}, "
                        f"got {values.dtype}")
    if (seg_ids.dtype != torch.int32 or seg_ids.dim() != 1
            or values.dim() not in (1, 2) or values.shape[0] != seg_ids.shape[0]):
        raise ValueError(f"need seg_ids int32 [E] and values [E] or [E, D]; got "
                         f"{seg_ids.dtype} {tuple(seg_ids.shape)} and "
                         f"{tuple(values.shape)}")
    if values.device != seg_ids.device:
        raise ValueError(f"values on {values.device}, seg_ids on {seg_ids.device}")
    if torch.is_grad_enabled() and values.requires_grad:
        # the kernel writes a fresh tensor through ctypes, with no grad_fn: a
        # loss through it would train with its gradients silently missing
        raise NotImplementedError(
            "segment_sum_sorted (K1) has no backward, as the JAX package's Pallas "
            "kernel has none: call it under torch.no_grad() or "
            "torch.inference_mode(), or run the plain path (kernel=False) to train")
    if values.device.type == "cpu":
        if bool((seg_ids[1:] < seg_ids[:-1]).any()):
            raise ValueError("segment_sum_sorted needs seg_ids in ascending "
                             "order (the kernel's precondition); sort them or "
                             "use ops.segment_sum(presorted=False)")
        return segment_sum_ref(values, seg_ids, num_segments, out_dtype)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for {values.device}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("the segment-sum kernel needs contiguous tensors")
    n_lanes = seg_ids.shape[0]
    if n_lanes >= 2**31 or num_segments >= 2**31:
        raise ValueError("the segment-sum kernel indexes lanes and rows in int32")

    if out_dtype == torch.float32:
        values = values.float()  # no copy when already float32
    lib = load_library()
    fn = getattr(lib, _ENTRY[values.dtype if out_dtype == torch.int32
                             else torch.float32])
    d = 1 if values.dim() == 1 else values.shape[1]
    out = torch.empty((num_segments,) + tuple(values.shape[1:]),
                      dtype=out_dtype, device=values.device)
    if num_segments == 0 or d == 0:
        return out
    # float32 carries at d = 1 (none for int32), span records at d > 1 (as
    # many as the card's SMs can hold blocks)
    sms = torch.cuda.get_device_properties(values.device).multi_processor_count if d > 1 else 0
    scratch = torch.empty(lib.segsum_scratch_ints(n_lanes, num_segments, d,
                                                  int(out_dtype == torch.float32), sms),
                          dtype=torch.int32, device=values.device)
    err = build.on_device(values.device, fn, values.data_ptr(), seg_ids.data_ptr(), n_lanes,
                          num_segments, d, out.data_ptr(), scratch.data_ptr())
    if err:
        raise build.launch_error(lib, "segsum_error_string", err, "segment-sum kernel")
    launches += 1
    return out


def segment_sum_rows_sorted(
    values: torch.Tensor, seg_ids: torch.Tensor, *, num_segments: int,
) -> torch.Tensor:
    """int32 segment sums of G independent rows in one call.

    Args:
      values:  [G, L] bool or int32.
      seg_ids: [G, L] int32, each row ascending on its own; ids outside
               [0, num_segments) dropped.
      num_segments: V, the output columns.

    Returns int32 [G, V]: row r is ``segment_sum_sorted`` of row r. On a CPU
    tensor the plain version (``ref.segment_sum_rows_ref``), after a check
    that every row ascends; on a CUDA tensor one call of the kernel for the
    whole group (a memset and one launch of row-local blocks), counted once
    in ``rows_launches``. The result is a
    [G, V] view of a [G, V + 1] buffer (the kernel's key space, its last
    column the sentinel's).
    """
    global rows_launches
    if values.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"row sums take bool or int32 values, got {values.dtype}")
    if (seg_ids.dtype != torch.int32 or seg_ids.dim() != 2
            or values.shape != seg_ids.shape):
        raise ValueError(f"need seg_ids int32 [G, L] and values of its shape; got "
                         f"{seg_ids.dtype} {tuple(seg_ids.shape)} and {tuple(values.shape)}")
    if values.device != seg_ids.device:
        raise ValueError(f"values on {values.device}, seg_ids on {seg_ids.device}")
    if values.device.type == "cpu":
        if bool((seg_ids[:, 1:] < seg_ids[:, :-1]).any()):
            raise ValueError("segment_sum_rows_sorted needs every row's seg_ids in "
                             "ascending order (the kernel's precondition)")
        return segment_sum_rows_ref(values, seg_ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for {values.device}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("the segment-sum kernel needs contiguous tensors")
    g, n_lanes = seg_ids.shape
    if g * n_lanes >= 2**31 or g * (num_segments + 1) >= 2**31:
        raise ValueError("the segment-sum kernel indexes G*L lanes and G*(V+1) keys in int32")
    lib = load_library()
    out = torch.empty((g, num_segments + 1), dtype=torch.int32, device=values.device)
    if g > 0:
        fn = lib.segsum_rows_u8 if values.dtype == torch.bool else lib.segsum_rows_i32
        err = build.on_device(values.device, fn, values.data_ptr(), seg_ids.data_ptr(), g,
                              n_lanes, num_segments, out.data_ptr())
        if err:
            raise build.launch_error(lib, "segsum_error_string", err, "segment-sum rows kernel")
        rows_launches += 1
    return out[:, :num_segments]


__all__ = ["segment_sum_sorted", "segment_sum_rows_sorted", "load_library", "SOURCE"]
