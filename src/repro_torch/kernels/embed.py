"""K5 on Hopper: the fused gather and segment-sum as a CUDA kernel written by
hand.

Replaces the JAX package's ``kernels/ops.py:segment_embed`` (a gather of the
rows, then the one-hot segment-sum K1 on the TPU). The kernel is
``csrc/embed.cu``; its header says what bounds it and how its design answers
that. It computes K5's function for one table or for T tables at once:

    out[s, :]    = sum over e with seg_ids[e] == s of w[e] * table[gather_ids[e], :]
    out[s, t, :] = sum over e with seg_ids[e] == s of w[t, e] * tables[t, gather_ids[t, e], :]

with one shared ``seg_ids`` sorted ascending. Gather ids outside ``[0, R)``
and segment ids outside ``[0, V)`` contribute nothing. For T tables the ids
may be ``[T, E]`` or a ``[T, E1, E2]`` view (E = E1 * E2, lane e at
``[t, e // E2, e % E2]``) whose last axis is contiguous: DCN-v2 passes its
``[B, T, M]`` ids as ``ids.permute(1, 0, 2)``, and the kernel reads them
through the strides, with no copy. Sortedness is a precondition of the
kernel (``ops.segment_embed(presorted=False)`` sorts first). The gathered
rows are never written to memory.

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

launches = 0     # kernel launches (one for all tables), counted where the kernel is launched
_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build the kernel library if this source was not built yet, load it
    and declare its C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_embed_f32.argtypes = [p, ll, i, i, p, ll, ll, ll, ll, p, p, i, p, p]
    lib.segment_embed_f32.restype = i
    lib.gather_ceiling_f32.argtypes = [p, ll, i, p, ll, ll, ll, ll, i, p, p, p]
    lib.gather_ceiling_f32.restype = i
    _lib = lib
    return lib


def _check(tables, gather_ids, seg_ids, weights) -> None:
    ts, gs, ss = tables.shape, gather_ids.shape, seg_ids.shape
    if tables.dtype != torch.float32 or len(ts) not in (2, 3):
        raise TypeError(f"segment_embed takes float32 [R, D] or [T, R, D] tables, got "
                        f"{tables.dtype} {tuple(ts)}")
    if len(ts) == 2:
        lanes_ok, want = gs == ss, "[E]"
    else:
        lanes_ok = (len(gs) in (2, 3) and gs[0] == ts[0] and len(ss) == 1
                    and (gs[1] if len(gs) == 2 else gs[1] * gs[2]) == ss[0])
        want = f"[{ts[0]}, E] or [{ts[0]}, E1, E2] with E1 * E2 = E"
    if (seg_ids.dtype != torch.int32 or len(ss) != 1 or gather_ids.dtype != torch.int32
            or not lanes_ok):
        raise ValueError(f"need int32 seg_ids [E] and gather_ids {want} for tables "
                         f"{tuple(ts)}; got {seg_ids.dtype} {tuple(ss)} "
                         f"and {gather_ids.dtype} {tuple(gs)}")
    if weights is not None and (weights.dtype != torch.float32 or weights.shape != gs):
        raise ValueError(f"weights must be float32 {list(gs)}, got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    dev = tables.device
    if (gather_ids.device != dev or seg_ids.device != dev
            or (weights is not None and weights.device != dev)):
        given = [tables, gather_ids, seg_ids] + ([] if weights is None else [weights])
        raise ValueError(f"inputs on several devices: {[str(t.device) for t in given]}")
    if torch.is_grad_enabled() and (tables.requires_grad or (weights is not None
                                                              and weights.requires_grad)):
        raise RuntimeError("segment_embed has no backward yet: call it under "
                           "torch.no_grad() or torch.inference_mode(), or run the plain "
                           "path (kernel=False) to train")


def _id_strides(tables: torch.Tensor, gather_ids: torch.Tensor) -> tuple[int, int, int]:
    """(t_stride, row_stride, cols) of the kernel's id addressing: lane e of
    table t at ``t * t_stride + (e // cols) * row_stride + e % cols``."""
    if tables.dim() == 2:
        return 0, gather_ids.shape[0], max(gather_ids.shape[0], 1)
    if gather_ids.dim() == 2:
        return gather_ids.stride(0), gather_ids.shape[1], max(gather_ids.shape[1], 1)
    return gather_ids.stride(0), gather_ids.stride(1), max(gather_ids.shape[2], 1)


def _launch(lib, tables, gather_ids, seg_ids, weights, out, stream) -> int:
    """The C call for checked inputs: ``out`` [V, T, D] (or [V, D])."""
    t_stride, row_stride, cols = _id_strides(tables, gather_ids)
    if weights is not None:  # [T, E] contiguous, held until the launch is enqueued
        weights = (weights.reshape(weights.shape[0], -1) if tables.dim() == 3
                   else weights).contiguous()
    return lib.segment_embed_f32(
        tables.data_ptr(), tables.shape[-2], tables.shape[-1],
        tables.shape[0] if tables.dim() == 3 else 1, gather_ids.data_ptr(), t_stride,
        row_stride, cols, seg_ids.shape[0], seg_ids.data_ptr(),
        None if weights is None else weights.data_ptr(), out.shape[0], out.data_ptr(), stream)


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
      gather_ids: int32 [E]; for T tables [T, E] or a [T, E1, E2] view with
                  E1 * E2 = E whose last axis is contiguous: the row of each
                  lane.
      seg_ids:    int32 [E], ascending, shared by every table.
      weights:    optional float32, the shape of ``gather_ids``.
      num_segments: output rows V.

    Returns float32 [V, D] (or [V, T, D]). On a CPU tensor this is the plain
    version (``ref.segment_embed_ref``), after a check that the ids ascend
    (``ValueError`` if not); on a CUDA tensor it is one launch of the kernel
    for all tables, counted in ``launches``.
    """
    global launches
    _check(tables, gather_ids, seg_ids, weights)
    dev = tables.device
    if dev.type == "cpu":
        if bool((seg_ids[1:] < seg_ids[:-1]).any()):
            raise ValueError("segment_embed_sorted needs seg_ids in ascending order "
                             "(the kernel's precondition); sort them or use "
                             "ops.segment_embed(presorted=False)")
        return segment_embed_ref(tables, gather_ids, seg_ids, weights, num_segments)
    if dev.type != "cuda":
        raise ValueError(f"no segment-embed kernel for {dev}")
    if not (tables.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("the segment-embed kernel needs contiguous tables and seg_ids")
    if gather_ids.shape[-1] > 1 and gather_ids.stride(-1) != 1:
        raise ValueError("the segment-embed kernel needs gather ids whose last axis is "
                         "contiguous")
    if (seg_ids.shape[0] >= 2**31 or num_segments >= 2**31
            or tables.shape[-2] >= 2**31):
        raise ValueError("the segment-embed kernel indexes lanes, bags and rows in int32")
    batched = tables.dim() == 3
    if batched and tables.shape[0] > MAX_TABLES:
        raise ValueError(f"the segment-embed kernel takes at most {MAX_TABLES} tables")
    d = tables.shape[-1]
    out = torch.empty((num_segments, tables.shape[0], d) if batched else (num_segments, d),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib or load_library()
    err = build.on_device(dev, _launch, lib, tables, gather_ids, seg_ids, weights, out)
    if err:
        raise build.launch_error(lib, "embed_error_string", err, "segment-embed kernel")
    launches += 1
    return out


def gather_ceiling(tables: torch.Tensor, gather_ids: torch.Tensor, *, tables_a_pass: int = 0,
                   out: torch.Tensor | None = None) -> None:
    """Diagnostic of ``chip_smoke.py``: the kernel ``gather_ceiling`` reads
    the rows of ``gather_ids`` ([T, E] or a [T, E1, E2] view as K5 takes
    them, E2 a multiple of 4, E a multiple of 16, every id in range) from
    ``tables`` ([T, R, 16] float32 on the card) in K5's order,
    ``tables_a_pass`` tables at a time (0: as K5 chooses), with no bag
    structure. Without ``out`` each thread writes one float of scratch; with
    ``out`` ([E / 4, T, 16] float32) it stores each four lanes' sum where K5
    stores a bag of 4. Its time is the card's for these random 64-byte rows
    (and those stores); the values are not a result."""
    n_tables, n_rows, d = tables.shape
    n_lanes = gather_ids[0].numel()
    t_stride, row_stride, cols = _id_strides(tables, gather_ids)
    if d != 16 or gather_ids.shape[0] != n_tables or n_lanes % 16 or cols % 4:
        raise ValueError("gather_ceiling takes [T, R, 16] tables and ids of 16k lanes a "
                         "table in rows of 4k")
    if out is not None and out.shape != (n_lanes // 4, n_tables, 16):
        raise ValueError(f"out must be [{n_lanes // 4}, {n_tables}, 16]")
    sink = None if out is not None else torch.empty(n_tables * n_lanes // 4,
                                                    dtype=torch.float32, device=tables.device)
    lib = load_library()
    err = build.on_device(tables.device, lib.gather_ceiling_f32, tables.data_ptr(), n_rows,
                          n_tables, gather_ids.data_ptr(), t_stride, row_stride, cols,
                          n_lanes, tables_a_pass, None if sink is None else sink.data_ptr(),
                          None if out is None else out.data_ptr())
    if err:
        raise build.launch_error(lib, "embed_error_string", err, "gather-ceiling kernel")


__all__ = ["segment_embed_sorted", "gather_ceiling", "load_library", "SOURCE"]
