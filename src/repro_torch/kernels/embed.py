"""K5 on Hopper: the fused gather and segment-sum as a CUDA kernel written by
hand.

Replaces the JAX package's ``kernels/ops.py:segment_embed`` (a gather of the
rows, then the one-hot segment-sum K1 on the TPU). The kernel is
``csrc/embed.cu``; its header says what bounds it and how its design answers
that. It computes K5's function for one table or for T tables at once:

    out[s, :]    = sum over e with seg_ids[e] == s of w[e] * table[gather_ids[e], :]
    out[s, t, :] = sum over e with seg_ids[e] == s of w[t, e] * tables[t, gather_ids[t, e], :]

with one shared ``seg_ids`` sorted ascending. Gather ids outside ``[0, R)``
and segment ids outside ``[0, V)`` contribute nothing. Sortedness is a
precondition of the kernel (``ops.segment_embed(presorted=False)`` sorts
first). The gathered rows are never written to memory.

The source is built at first use by ``kernels/build.py``. A failed build or
launch raises. A CUDA tensor never falls back to the plain version, which
runs only for tensors on the CPU; there unsorted ids raise ``ValueError`` as
they do for K1. There is no backward yet: with autograd on, an input that
requires a gradient raises, so a ``backward()`` cannot silently leave the
tables without one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_embed_ref

SOURCE = build.CSRC / "embed.cu"
MAX_TABLES = 65535  # the kernel's grid y axis

launches = 0     # kernel calls (one for all tables), counted where the kernel is launched
_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build the kernel library if this source was not built yet, load it
    and declare its C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_embed_f32.argtypes = [p, ll, i, i, p, ll, p, p, i, p, p, p]
    lib.segment_embed_f32.restype = i
    lib.embed_scratch_ints.argtypes = [i]
    lib.embed_scratch_ints.restype = ll
    _lib = lib
    return lib


def _check(tables, gather_ids, seg_ids, weights) -> None:
    if tables.dtype != torch.float32 or tables.dim() not in (2, 3):
        raise TypeError(f"segment_embed takes float32 [R, D] or [T, R, D] tables, got "
                        f"{tables.dtype} {tuple(tables.shape)}")
    want = tables.shape[:1] + seg_ids.shape if tables.dim() == 3 else seg_ids.shape
    if (seg_ids.dtype != torch.int32 or seg_ids.dim() != 1
            or gather_ids.dtype != torch.int32 or gather_ids.shape != want):
        raise ValueError(f"need int32 seg_ids [E] and gather_ids {list(want)} for tables "
                         f"{tuple(tables.shape)}; got {seg_ids.dtype} {tuple(seg_ids.shape)} "
                         f"and {gather_ids.dtype} {tuple(gather_ids.shape)}")
    if weights is not None and (weights.dtype != torch.float32 or weights.shape != want):
        raise ValueError(f"weights must be float32 {list(want)}, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    given = [tables, gather_ids, seg_ids] + ([] if weights is None else [weights])
    if len({t.device for t in given}) != 1:
        raise ValueError(f"inputs on several devices: {[str(t.device) for t in given]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise RuntimeError("segment_embed has no backward yet: call it under "
                           "torch.no_grad() or torch.inference_mode(), or run the plain "
                           "path (kernel=False) to train")


def segment_embed_sorted(
    tables: torch.Tensor,
    gather_ids: torch.Tensor,
    seg_ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    num_segments: int,
) -> torch.Tensor:
    """Gather and weighted segment-sum for lanes **sorted by seg_ids**.

    Args:
      tables:     float32 [R, D], or [T, R, D] for T tables at once.
      gather_ids: int32 [E] (or [T, E]): the row of each lane.
      seg_ids:    int32 [E], ascending, shared by every table.
      weights:    optional float32, the shape of ``gather_ids``.
      num_segments: output rows V.

    Returns float32 [V, D] (or [V, T, D]). On a CPU tensor this is the plain
    version (``ref.segment_embed_ref``), after a check that the ids ascend
    (``ValueError`` if not); on a CUDA tensor it is one call of the kernel
    for all tables (two CUDA launches: bag offsets, then the fused gather
    and sum), counted once in ``launches``.
    """
    global launches
    _check(tables, gather_ids, seg_ids, weights)
    if tables.device.type == "cpu":
        if bool((seg_ids[1:] < seg_ids[:-1]).any()):
            raise ValueError("segment_embed_sorted needs seg_ids in ascending order "
                             "(the kernel's precondition); sort them or use "
                             "ops.segment_embed(presorted=False)")
        return segment_embed_ref(tables, gather_ids, seg_ids, weights, num_segments)
    if tables.device.type != "cuda":
        raise ValueError(f"no segment-embed kernel for {tables.device}")
    given = [tables, gather_ids, seg_ids] + ([] if weights is None else [weights])
    if not all(t.is_contiguous() for t in given):
        raise ValueError("the segment-embed kernel needs contiguous tensors")
    n_lanes = seg_ids.shape[0]
    if n_lanes >= 2**31 or num_segments >= 2**31 or tables.shape[-2] >= 2**31:
        raise ValueError("the segment-embed kernel indexes lanes, bags and rows in int32")
    batched = tables.dim() == 3
    n_tables = tables.shape[0] if batched else 1
    if n_tables > MAX_TABLES:
        raise ValueError(f"the segment-embed kernel takes at most {MAX_TABLES} tables")
    n_rows, d = tables.shape[-2:]
    out = torch.empty((num_segments, n_tables, d) if batched else (num_segments, d),
                      dtype=torch.float32, device=tables.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    scratch = torch.empty(lib.embed_scratch_ints(num_segments), dtype=torch.int32,
                          device=tables.device)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segment_embed_f32(tables.data_ptr(), n_rows, d, n_tables,
                                    gather_ids.data_ptr(), n_lanes, seg_ids.data_ptr(),
                                    None if weights is None else weights.data_ptr(),
                                    num_segments, out.data_ptr(), scratch.data_ptr(), stream)
    if err:
        raise build.launch_error(lib, "embed_error_string", err, "segment-embed kernel")
    launches += 1
    return out


__all__ = ["segment_embed_sorted", "load_library", "SOURCE"]
