"""What a rank holds in the LM train kind over a mesh, on rank 0 of the dry
16 x 16 production mesh (``launch.dryrun``: meta tensors, nothing run).

Each block gathers its weights inside its remat and each gradient leaves
the backward at this rank's slice, so a layer adds to the step's peak only
what a rank keeps of it: its slices, their optimizer state, its share of
the accumulator and the block's input saved for the recompute. Holding
every gathered weight, a gathered-size accumulator and a gathered-size
microbatch gradient added about three and a half gathered blocks a layer.

mistral-nemo-12b (tp_sp, FSDP over "data", 4 microbatches accumulated in
float32, AdamW) and qwen2.5-3b (zero3 over the whole mesh, one
microbatch) at their published widths, cut to 2 and to 4 layers: the
peak grows by less than one block's gathered weights a layer.
"""
import dataclasses
import math
from unittest import mock

import pytest

torch = pytest.importorskip("torch")


def _cut(name: str, n_layers: int):
    from repro_torch.configs import get_arch

    arch = get_arch(name)
    return dataclasses.replace(arch, full=dataclasses.replace(arch.full, n_layers=n_layers))


def _peak_and_block(name: str, n_layers: int) -> tuple[int, int]:
    """(the train_4k cell's peak bytes on rank 0, one block's weights as
    the rank gathers them, in bytes)."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import dry_mesh, make_production_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.models.shard import spec_axes

    arch = _cut(name, n_layers)
    with mock.patch.object(steps, "get_arch", lambda _: arch), \
            mock.patch.object(dryrun, "get_arch", lambda _: arch):
        rec = dryrun.run_cell(name, "train_4k", False, verbose=False)
        mesh = dry_mesh(make_production_mesh())
        step = steps.build_step(name, "train_4k", mesh=mesh)
    assert rec["ok"], rec.get("trace")
    keep = {step.ctx.tp} - {None}   # tp_sp keeps the tensor axis' split
    block = 0
    for k, shape in lm.param_shapes(step.cfg).items():
        if k.startswith("dense_blocks.0."):
            kept = math.prod(mesh.axis_size(a) for a in spec_axes(step.specs[k]) if a in keep)
            block += math.prod(shape) // kept * step.cfg.param_dtype.itemsize
    return rec["peak_bytes"], block


@pytest.mark.parametrize("name,layout", [("mistral-nemo-12b", "tp_sp"), ("qwen2.5-3b", "zero3")])
def test_train_peak_grows_under_one_gathered_block_a_layer(name, layout):
    p2, block = _peak_and_block(name, 2)
    p4, _ = _peak_and_block(name, 4)
    assert _cut(name, 2).train_layout == layout
    assert 0 < (p4 - p2) / 2 < block, ((p4 - p2) / 2, block)
