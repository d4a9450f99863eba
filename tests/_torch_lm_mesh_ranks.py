"""One rank of the port's transformer over a mesh on the CPU: the sequence
that tests/test_torch_lm_mesh.py runs at world sizes 1 (in process), 2, 4
and 8 (one process a rank over a gloo group) and holds against the JAX
package.

    python tests/_torch_lm_mesh_ranks.py RANK WORLD INIT_METHOD REF.npz OUT.npz

For every mesh of its world over ``("data", "model")`` it runs, from the
JAX package's parameters and tokens (read from ``REF.npz``): the loss and
its gradients through the train kind's ``step.grad`` (tp_sp, and zero3 for
the dense configs), a train step against the same step on one device, the
sharded optimizers against their one-device updates, prefill (logits and
its cache) and decode steps in ``decode_cache_specs``' layout (a batch of 4,
a batch of one with a sliding window or MLA's every-axis sequence, an int8
cache), and ``restore_elastic`` of the JAX package's state saved on a 2 x 4
mesh. Every tensor it returns is put back whole over the mesh first.
:func:`scripted` returns a flat dict of arrays; a rank writes it to
``OUT.npz``. With ``-`` for ``REF.npz`` it runs :func:`card` on cuda:0
(tests/test_torch_gpu.py). It imports torch and the port only (the configs are built by
either package's classes: :func:`lm_configs`).
"""
from __future__ import annotations

import sys
from dataclasses import replace

import numpy as np

AXES = ("data", "model")
MESHES = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2)], 8: [(2, 4)]}
BATCH, SEQ, NEW = 4, 16, 8       # prompts, their tokens, decoded tokens (SEQ + NEW splits 8 ways)
WINDOW = 8                       # the batch-of-one GQA decode's sliding window
TRAIN_SEQ = 8                    # the train kind's rows (BATCH of them, 2 microbatches)


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def lm_configs(transformer_config, moe_config, f32) -> dict:
    """tests/test_distributed.py:92's config ("gqa"), the same with a
    vocabulary that does not split over 4 ranks ("gqa66"), and a small
    MLA + MoE + MTP config whose 6 experts run ``moe_ep`` over 1 or 2
    model ranks and ``moe_tp`` over 4 ("mla"), built by either package's
    classes."""
    gqa = transformer_config(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                             d_ff=64, vocab=64, param_dtype=f32, compute_dtype=f32)
    return {
        "gqa": gqa,
        "gqa66": replace(gqa, vocab=66),
        "mla": transformer_config(
            name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, vocab=64,
            attn="mla", q_lora_rank=16, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
            v_head_dim=8, n_dense_layers=1, mtp=True, param_dtype=f32, compute_dtype=f32,
            moe=moe_config(n_experts=6, top_k=2, d_model=32, d_ff=16, n_shared=1,
                           capacity_factor=8.0, compute_dtype=f32)),
    }


def serve_cases(cfgs: dict) -> dict:
    """name -> (config, batch) of the prefill / decode cases."""
    return {"gqa": (cfgs["gqa"], BATCH),
            "gqa-b1": (replace(cfgs["gqa"], sliding_window=WINDOW), 1),
            "gqa-int8": (replace(cfgs["gqa"], kv_cache_dtype="int8"), BATCH),
            "mla": (cfgs["mla"], BATCH),
            "mla-b1": (cfgs["mla"], 1)}


def tokens(vocab: int, rows: int, cols: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (rows, cols)).astype(np.int32)


def train_batch(vocab: int) -> dict:
    """The train kind's batch: ``BATCH`` rows of ``TRAIN_SEQ`` tokens, in 2
    microbatches of 2 rows."""
    return {"tokens": tokens(vocab, BATCH, TRAIN_SEQ, 3),
            "labels": tokens(vocab, BATCH, TRAIN_SEQ, 4)}


def decode_cache(cfg, batch: int, cache0: dict, init_cache) -> dict:
    """The decode cases' whole cache of ``SEQ + NEW`` entries from the
    prefill cache ``cache0`` (numpy, ``[L, B, SEQ, ...]``): the prompt's
    entries (a window's last ``WINDOW``, at their ring slots), zeros after;
    an int8 config starts from zeros (its prefill cache is float)."""
    whole = {k: np.array(v) for k, v in init_cache(cfg, batch, SEQ + NEW).items()}
    if cfg.kv_cache_dtype == "int8":
        return whole
    for k, v in cache0.items():
        if cfg.sliding_window:
            w = cfg.sliding_window
            for pos in range(SEQ - w, SEQ):
                whole[k][:, :, pos % w] = v[:, :, pos]
        else:
            whole[k][:, :, :SEQ] = v
    return whole


def decode_start(cfg) -> int:
    return 0 if cfg.kv_cache_dtype == "int8" else SEQ


def _arch(cfg, optimizer: str, microbatches: int, layout: str):
    from repro_torch.configs.common import Arch, Shape

    return Arch(name=cfg.name, family="lm", full=cfg, smoke=cfg, optimizer=optimizer,
                microbatches=microbatches, train_layout=layout,
                shapes=(Shape("train_4k", "train", dict(seq_len=TRAIN_SEQ,
                                                       global_batch=BATCH)),))


def build_train_step(cfg, optimizer: str, layout: str, mesh):
    """The train kind of a config not in the registry (``get_arch``
    patched, as tests/_torch_lm.py does)."""
    from repro_torch.launch import steps

    arch = _arch(cfg, optimizer, 2, layout)
    saved = steps.get_arch
    steps.get_arch = lambda name: arch
    try:
        return steps.build_step(cfg.name, "train_4k", device="cpu", mesh=mesh)
    finally:
        steps.get_arch = saved


def whole(t, spec, mesh):
    """A rank's slice put back together over the mesh (no gradient)."""
    import torch

    from repro_torch.models.shard import gather

    with torch.no_grad():
        return gather(t.detach(), spec, mesh).float().cpu().numpy()


def scripted(mesh, ref: dict) -> dict:
    import torch

    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.steps import train_state
    from repro_torch.models import MoEConfig, TransformerConfig, lm_params_from_jax
    from repro_torch.models import transformer as lm
    from repro_torch.models.shard import local_slice
    from repro_torch.optim import adafactor, adamw

    torch.set_float32_matmul_precision("highest")
    key = tag(mesh.shape)
    out = {}
    cfgs = lm_configs(TransformerConfig, MoEConfig, torch.float32)

    def tree(name):
        pre = f"p/{name}/"
        return _unflatten({k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})

    # the train kind's loss and gradients, and one step against one device
    for name, cfg in cfgs.items():
        layouts = ("tp_sp", "zero3") if cfg.moe is None else ("tp_sp",)
        batch = train_batch(cfg.vocab)
        for layout in layouts:
            step = build_train_step(cfg, "adamw", layout, mesh)
            model = lm_params_from_jax(tree(name), cfg, mesh=mesh, specs=step.specs)
            state = train_state(model, step.opt, (mesh, step.specs))
            loss, grads = step.grad(state["params"], batch)
            base = f"{key}/{name}/{layout}"
            out[f"{base}/loss"] = np.array(float(loss))
            out.update({f"{base}/g/{k}": whole(g, step.specs[k], mesh) for k, g in grads.items()})
            new_p, _, loss2 = step.fn(state["params"], state["opt"], batch)
            out[f"{base}/step_loss"] = np.array(float(loss2))
            out.update({f"{base}/new/{k}": whole(p, step.specs[k], mesh)
                        for k, p in new_p.items()})

    # the sharded optimizers (Adafactor factored at 8 x 8 and up) against one device
    cfg = cfgs["gqa"]
    specs = lm.param_specs(cfg, mesh)
    full = lm_params_from_jax(tree("gqa"), cfg, device="cpu")
    whole_p = {k: v.detach() for k, v in full.named_parameters()}
    rng = np.random.default_rng(5)
    whole_g = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
               for k, v in whole_p.items()}
    for oname, opt in (("adamw", adamw(1e-3)), ("adafactor", adafactor(1e-2, min_dim_factored=8))):
        mine = {k: local_slice(v, specs[k], mesh).contiguous() for k, v in whole_p.items()}
        g = {k: local_slice(v, specs[k], mesh).contiguous() for k, v in whole_g.items()}
        st = opt.init(mine, (mesh, specs))
        for _ in range(2):
            mine, st = opt.update(g, st, mine, (mesh, specs))
        out.update({f"{key}/opt/{oname}/{k}": whole(v, specs[k], mesh) for k, v in mine.items()})

    # prefill and decode
    for name, (cfg, batch) in serve_cases(cfgs).items():
        base_cfg = "mla" if name.startswith("mla") else "gqa"
        specs = lm.param_specs(cfg, mesh)
        model = lm_params_from_jax(tree(base_cfg), cfg, mesh=mesh, specs=specs)
        toks = torch.from_numpy(tokens(cfg.vocab, batch, SEQ + NEW, 7))
        dp = dp_axes(mesh)
        base = f"{key}/serve/{name}"
        with torch.no_grad():
            if batch > 1 and cfg.kv_cache_dtype is None:
                ctx = lm.ShardCtx(mesh, dp, sp=True)
                rows = batch // mesh.axis_size(dp)
                mine = toks[mesh.axis_index(dp) * rows:][:rows, :SEQ]
                lg, cache = lm.prefill(model, mine, cfg, ctx=ctx, mesh=mesh)
                out[f"{base}/prefill"] = whole(lg, (dp, None), mesh)
                cs = lm.cache_specs(cfg, dp)
                out.update({f"{base}/cache/{k}": whole(v, cs[k], mesh) for k, v in cache.items()})
            cache0 = {k[len(f"serve/{name}/cache/"):]: v for k, v in ref.items()
                      if k.startswith(f"serve/{name}/cache/")}
            dspecs = lm.decode_cache_specs(cfg, mesh, batch)
            full_cache = decode_cache(cfg, batch, cache0, lambda *a: lm.init_cache(
                *a, device="cpu"))
            c = {k: local_slice(torch.from_numpy(v), dspecs[k], mesh).clone()
                 for k, v in full_cache.items()}
            dctx = lm.ShardCtx(mesh, dp if batch > 1 else ())
            rows = batch // mesh.axis_size(dctx.dp)
            first = mesh.axis_index(dctx.dp) * rows
            logits = []
            for t in range(decode_start(cfg), SEQ + NEW):
                lg, c = lm.decode_step(model, c, toks[first:first + rows, t], t, cfg,
                                       ctx=dctx, mesh=mesh)
                logits.append(whole(lg, (dctx.dp or None, None), mesh))
            out[f"{base}/decode"] = np.stack(logits, axis=1)

    # restore_elastic of the JAX package's 2 x 4 state, by specs
    out.update(_restore(mesh, ref, cfgs["gqa"]))
    return out


def _restore(mesh, ref: dict, cfg) -> dict:
    """``restore_elastic`` of the JAX package's train state (bfloat16
    parameters, float32 AdamW moments) saved on its 2 x 4 mesh, onto this
    mesh by ``lm_state_specs``; then the same state written through
    ``lm_sharded_layout`` and read back by another layout of the ranks."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import restore_elastic
    from repro_torch.models import LM_STATE_LAYOUT, lm_sharded_layout, lm_state_specs
    from repro_torch.models import transformer as lm
    from repro_torch.models.shard import local_shape

    out = {}
    cfg = replace(cfg, param_dtype=torch.bfloat16)
    key = tag(mesh.shape)
    for layout, specs in (("tp", lm.param_specs(cfg, mesh)),
                          ("zero3", lm.param_specs_zero3(cfg, mesh))):
        shapes = lm.param_shapes(cfg)
        params = {k: torch.zeros(local_shape(s, specs[k], mesh), dtype=torch.bfloat16)
                  for k, s in shapes.items()}
        f32 = {k: torch.zeros(v.shape) for k, v in params.items()}
        template = {"params": params, "opt": {"step": torch.zeros((), dtype=torch.int32),
                                              "mu": f32, "nu": dict(f32)}}
        sspecs = lm_state_specs(template, specs)
        ckpt = CheckpointManager(str(ref["ckpt_dir"]), layout=LM_STATE_LAYOUT)
        step, st = restore_elastic(ckpt, template, mesh=mesh, specs=sspecs)
        base = f"{key}/restore/{layout}"
        out[f"{base}/step"] = np.array(step)
        out[f"{base}/dtype"] = np.array(str(st["params"]["embed"].dtype))
        out.update({f"{base}/params/{k}": whole(v, specs[k], mesh)
                    for k, v in st["params"].items()})
        out.update({f"{base}/mu/{k}": whole(v, specs[k], mesh)
                    for k, v in st["opt"]["mu"].items()})
        # written whole through the sharded layout by every rank (each its
        # own directory), read back as the JAX layout on one device
        mine = CheckpointManager(f"{ref['tmp_dir']}/{key}-{layout}-rank{mesh.rank}",
                                 layout=lm_sharded_layout(mesh, specs), async_save=False)
        mine.save(step + 1, st)
        back = CheckpointManager(mine.dir, layout=LM_STATE_LAYOUT)
        whole_t = {"params": {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()},
                   "opt": {"step": torch.zeros((), dtype=torch.int32),
                           "mu": {k: torch.zeros(s) for k, s in shapes.items()},
                           "nu": {k: torch.zeros(s) for k, s in shapes.items()}}}
        s2, host = back.restore(whole_t, step=step + 1)
        out[f"{base}/rewritten_step"] = np.array(s2)
        out.update({f"{base}/rewritten/{k}": v.float().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v, dtype=np.float32)
                    for k, v in host["params"].items()})
    return out


def _unflatten(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` as nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def seeded_gqa(device="cpu"):
    """The "gqa" config and a model of it drawn from seed 0 (the card mode's
    and its CPU answer's, no JAX)."""
    import torch

    from repro_torch.models import MoEConfig, TransformerConfig, init_params

    cfg = lm_configs(TransformerConfig, MoEConfig, torch.float32)["gqa"]
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, device=device, generator=gen)


def card(mesh) -> dict:
    """The card mode: the "gqa" config drawn from a seed on the CPU, this
    rank's slices on cuda:0; the train kind's loss and gradients (tp_sp,
    zero3), prefill's logits and decode's, each put back whole."""
    import torch

    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.steps import train_state
    from repro_torch.models import transformer as lm

    torch.set_float32_matmul_precision("highest")
    cfg, model = seeded_gqa()
    whole_p = {k: v.detach() for k, v in model.named_parameters()}
    out, key = {}, tag(mesh.shape)
    for layout in ("tp_sp", "zero3"):
        step = build_train_step(cfg, "adamw", layout, mesh)
        params = {k: local_slice_to(v, step.specs[k], mesh) for k, v in whole_p.items()}
        loss, grads = step.grad(params, train_batch(cfg.vocab))
        out[f"{key}/{layout}/loss"] = np.array(float(loss))
        out.update({f"{key}/{layout}/g/{k}": whole(g, step.specs[k], mesh).astype(np.float32)
                    for k, g in grads.items()})
        again = step.grad(params, train_batch(cfg.vocab))
        out[f"{key}/{layout}/bitwise"] = np.array(bool(
            torch.equal(again[0], loss) and all(torch.equal(again[1][k], g)
                                                for k, g in grads.items())))
    specs = lm.param_specs(cfg, mesh)
    sharded = lm.sharded(cfg, mesh, specs)
    with torch.no_grad():
        for k, p in sharded.named_parameters():
            p.copy_(local_slice_to(whole_p[k], specs[k], mesh))
        dp = dp_axes(mesh)
        toks = torch.from_numpy(tokens(cfg.vocab, BATCH, SEQ + NEW, 7)).to(mesh.device)
        rows = BATCH // mesh.axis_size(dp)
        mine = toks[mesh.axis_index(dp) * rows:][:rows]
        lg, cache = lm.prefill(sharded, mine[:, :SEQ], cfg, ctx=lm.ShardCtx(mesh, dp, sp=True),
                               mesh=mesh)
        out[f"{key}/prefill"] = whole(lg, (dp, None), mesh)
        dspecs = lm.decode_cache_specs(cfg, mesh, BATCH)
        c = lm.init_cache(cfg, BATCH, SEQ + NEW, mesh=mesh, specs=dspecs)
        logits = []
        for t in range(SEQ + NEW):
            lg, c = lm.decode_step(sharded, c, mine[:, t], t, cfg,
                                   ctx=lm.ShardCtx(mesh, dp), mesh=mesh)
            logits.append(whole(lg, (dp, None), mesh))
        out[f"{key}/decode"] = np.stack(logits, axis=1)
    return out


def local_slice_to(t, spec, mesh):
    from repro_torch.models.shard import local_slice

    return local_slice(t, spec, mesh).contiguous().to(mesh.device)


def main(argv: list[str]) -> int:
    """``REF.npz`` ``-`` is the card mode (:func:`card`): world 2 over
    (1, 2) with every rank on cuda:0."""
    rank, world, init, ref_path, out_path = argv
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    torch.set_num_threads(1)
    on_card = ref_path == "-"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=int(world), rank=int(rank))
    try:
        out = {}
        if on_card:
            out.update(card(make_mesh((1, 2), AXES, device="cuda:0")))
        else:
            ref = dict(np.load(ref_path))
            for shape in MESHES[int(world)]:
                out.update(scripted(make_mesh(shape, AXES, device="cpu"), ref))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
