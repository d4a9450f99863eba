"""K2 on Hopper: the peel's edge stage as one fused CUDA kernel written by hand.

Replaces the JAX package's ``kernels/ops.py:peel_update`` (a gather, a mask
and the Pallas segment-sum K1) and the edge stage its peel bodies build
around K1. The kernel is ``csrc/peel.cu`` on the segmented-reduction core
``csrc/seg_reduce.cuh``; their headers say what bounds it and how the design
answers that. It computes ``ref.peel_edges_ref``: over dst-sorted COO lanes,

    live = src < n & dst < n & active[src] & active[dst]
    fs = failed[src] & live,  fd = failed[dst] & live
    delta[v] = sum_{dst=v} fs,  removed = sum (fs | fd)
    inc[v] = sum_{dst=v} fd & (~fs | dst < src)          (charge only)

in int32, in one pass over the lanes and with no host sync. Sortedness of
``dst`` is a precondition, as for K1: on the CPU unsorted lanes raise
``ValueError``. The source is built at first use by ``kernels/build.py``; a
CUDA tensor launches the kernel or raises, and never falls back to the
plain version, which runs only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import peel_edges_ref, peel_edges_rows_ref

SOURCE = build.CSRC / "peel.cu"

# The packed vertex state (2 bits a vertex) of the one-row entry is kept in
# each block's shared memory up to this many bytes (819,200 vertices), and
# read through L1/L2 above it; chip_smoke.py times both at the main path's
# 524,288 vertices.
SHARED_STATE_BYTES = 200 * 1024
# The rows entry packs a row's state into the shared memory of each block
# of that row up to this many bytes (262,144 vertices a row), and reads the
# row's mask bytes through L1/L2 above it: every block reads its row's 2V
# mask bytes to pack them, which stops paying once that read outgrows the
# lanes a block owns. chip_smoke.py times both sides.
ROWS_SHARED_STATE_BYTES = 64 * 1024

launches = 0       # peel_edges_sorted launches, counted where the kernel is launched
rows_launches = 0  # peel_edges_rows launches (one for a whole group of rows)
_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build the kernel library if this source was not built yet, load it
    and declare its C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load(SOURCE)
    lib.peel_edges.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.peel_edges.restype = ctypes.c_int
    lib.peel_edges_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.peel_edges_rows.restype = ctypes.c_int
    lib.peel_rows_buffer_ints.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.peel_rows_buffer_ints.restype = ctypes.c_longlong
    lib.peel_buffer_ints.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.peel_buffer_ints.restype = ctypes.c_longlong
    lib.peel_state_bytes.argtypes = [ctypes.c_longlong]
    lib.peel_state_bytes.restype = ctypes.c_longlong
    _lib = lib
    return lib


def peel_edges_sorted(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None,
    failed: torch.Tensor,
    *,
    n_nodes: int,
    charge: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The edge stage of one peel pass over lanes **sorted by dst**.

    Args:
      src, dst: int32 [E], ids in [0, n_nodes] (n_nodes is the sentinel),
                dst ascending.
      active:   bool [n_nodes] live mask, or None for every vertex live.
      failed:   bool [n_nodes] vertices that fail this pass.
      n_nodes:  V.
      charge:   also return refinement's edge charges ``inc``.

    Returns int32 ``(delta [V], removed [])``, or ``(delta, removed, inc
    [V])`` with ``charge``. On a CPU tensor this is the plain version
    (``ref.peel_edges_ref``), after a check that dst ascends; on a CUDA
    tensor one call of the kernel (two CUDA launches: pack the vertex state
    and zero the outputs, then the pass over the lanes), counted once in
    ``launches``. The outputs are views of one buffer.
    """
    global launches
    if (src.dtype != torch.int32 or dst.dtype != torch.int32 or src.dim() != 1
            or src.shape != dst.shape):
        raise ValueError(f"need src and dst int32 [E]; got {src.dtype} "
                         f"{tuple(src.shape)} and {dst.dtype} {tuple(dst.shape)}")
    masks = [failed] + ([] if active is None else [active])
    if any(m.dtype != torch.bool or m.shape != (n_nodes,) for m in masks):
        raise ValueError(f"need active/failed bool [{n_nodes}]")
    if any(t.device != dst.device for t in [src] + masks):
        raise ValueError("src, dst, active and failed must be on one device")
    if dst.device.type == "cpu":
        if bool((dst[1:] < dst[:-1]).any()):
            raise ValueError("peel_edges_sorted needs dst in ascending order (the "
                             "kernel's precondition); use ops.peel_update(presorted=False)")
        return peel_edges_ref(src, dst, active, failed, n_nodes, charge)
    if dst.device.type != "cuda":
        raise ValueError(f"no peel kernel for {dst.device}")
    if not all(t.is_contiguous() for t in [src, dst] + masks):
        raise ValueError("the peel kernel needs contiguous tensors")
    n_lanes = dst.shape[0]
    if n_lanes >= 2**31 or n_nodes >= 2**31:
        raise ValueError("the peel kernel indexes lanes and vertices in int32")

    lib = load_library()
    buf = torch.empty(lib.peel_buffer_ints(n_nodes, int(charge)), dtype=torch.int32,
                      device=dst.device)
    if n_nodes > 0:
        err = build.on_device(dst.device, lib.peel_edges, src.data_ptr(), dst.data_ptr(),
                              n_lanes, n_nodes, None if active is None else active.data_ptr(),
                              failed.data_ptr(), int(charge), SHARED_STATE_BYTES,
                              buf.data_ptr())
        if err:
            raise build.launch_error(lib, "peel_error_string", err, "peel kernel")
        launches += 1
    else:
        buf.zero_()
    out = (buf[:n_nodes], buf[n_nodes])
    return out + (buf[n_nodes + 1:2 * n_nodes + 1],) if charge else out


def peel_edges_rows(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None,
    failed: torch.Tensor,
    *,
    n_nodes: int,
    charge: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The edge stage of G independent peel passes in one call: the batched
    pass of a bucket of fused tenants.

    Args:
      src, dst: int32 [G, L], ids in [0, n_nodes] (n_nodes the sentinel),
                each row's dst ascending on its own.
      active:   bool [G, n_nodes] live masks, or None for every vertex live.
      failed:   bool [G, n_nodes] vertices that fail this pass.
      n_nodes:  V, the vertices of a row.
      charge:   also return refinement's edge charges ``inc``.

    Returns int32 ``(delta [G, V], removed [G])``, or ``(delta, removed, inc
    [G, V])`` with ``charge``: row r's are ``peel_edges_sorted`` of row r. On
    a CPU tensor this is the plain version (``ref.peel_edges_rows_ref``),
    after a check that every row's dst ascends; on a CUDA tensor one call of
    the kernel for the whole group (a memset of the outputs and one launch
    of row-local blocks, each packing its row's state into shared memory up
    to ``ROWS_SHARED_STATE_BYTES``), counted once in ``rows_launches``.
    ``delta`` and ``inc`` are [G, V] views of a [G, V + 1] buffer (the
    kernel's key space, its last column the sentinel's).
    """
    global rows_launches
    if (src.dtype != torch.int32 or dst.dtype != torch.int32 or src.dim() != 2
            or src.shape != dst.shape):
        raise ValueError(f"need src and dst int32 [G, L]; got {src.dtype} "
                         f"{tuple(src.shape)} and {dst.dtype} {tuple(dst.shape)}")
    g, n_lanes = src.shape
    masks = [failed] + ([] if active is None else [active])
    if any(m.dtype != torch.bool or m.shape != (g, n_nodes) for m in masks):
        raise ValueError(f"need active/failed bool [{g}, {n_nodes}]")
    if any(t.device != dst.device for t in [src] + masks):
        raise ValueError("src, dst, active and failed must be on one device")
    if dst.device.type == "cpu":
        # repro: allow RPR101 -- CPU path only: a CPU tensor has no card to wait for
        if bool((dst[:, 1:] < dst[:, :-1]).any()):
            raise ValueError("peel_edges_rows needs every row's dst in ascending order "
                             "(the kernel's precondition)")
        return peel_edges_rows_ref(src, dst, active, failed, n_nodes, charge)
    if dst.device.type != "cuda":
        raise ValueError(f"no peel kernel for {dst.device}")
    if not all(t.is_contiguous() for t in [src, dst] + masks):
        raise ValueError("the peel kernel needs contiguous tensors")
    if g * n_lanes >= 2**31 or g * (n_nodes + 1) >= 2**31:
        raise ValueError("the peel kernel indexes G*L lanes and G*(V+1) keys in int32")

    lib = load_library()
    buf = torch.empty(lib.peel_rows_buffer_ints(g, n_nodes, int(charge)), dtype=torch.int32,
                      device=dst.device)
    keys = g * (n_nodes + 1)
    if g > 0 and n_nodes > 0:
        err = build.on_device(dst.device, lib.peel_edges_rows, src.data_ptr(), dst.data_ptr(),
                              g, n_lanes, n_nodes,
                              None if active is None else active.data_ptr(),
                              failed.data_ptr(), int(charge), ROWS_SHARED_STATE_BYTES,
                              buf.data_ptr())
        if err:
            raise build.launch_error(lib, "peel_error_string", err, "peel rows kernel")
        rows_launches += 1
    else:
        buf.zero_()
    delta = buf[:keys].view(g, n_nodes + 1)[:, :n_nodes]
    out = (delta, buf[keys:keys + g])
    if not charge:
        return out
    return out + (buf[keys + g:2 * keys + g].view(g, n_nodes + 1)[:, :n_nodes],)


__all__ = ["peel_edges_sorted", "peel_edges_rows", "load_library", "SOURCE",
           "SHARED_STATE_BYTES", "ROWS_SHARED_STATE_BYTES"]
