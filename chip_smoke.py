#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py           # every phase below
    python3 chip_smoke.py --rows    # phase 1, then only the rows kernels' numbers
                                    # of phase 12, on its lane bucket built directly

Builds the hand-written kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once) and drives the port's paths at full width:
P-Bahmani and CBDS-P on the Graph500 RMAT graph ``rmat(19, 16, seed=0)``
(524,288 vertices, 15,482,624 edge lanes, the largest Graph500 scale inside
the 2^24-lane exactness envelope), the candidate-pruned peel on the planted
block ``planted_dense(2**19, 2048, 16 / 2**19, 0.9, seed=0)`` (a 2,048-vertex
dense block in a sparse background of 524,288; 12,158,464 lanes), and
refinement rounds on the RMAT graph, and DCN-v2 serving and retrieval at the
published widths of ``configs/dcn_v2.py:FULL`` (26 tables of 1,000,000 x 16
float32) with two departures: ``multi_hot=4``, so that the EmbeddingBag
reaches the fused gather-and-segment-sum K5 (``multi_hot=1``, FULL's value,
takes a plain gather), and the kernel switched on. Phases:

  1. card and build: ``nvidia-smi`` name and power limit, versions, build time;
  2. the kernels against their plain versions on the card, at the cases of
     ``tests/test_kernels.py`` (K4: also the edges of its 4,096-lane tiles and
     a fill tail of many tiles; K5: also invalid ids, empty bags, segment ids
     past V, the scalar path, 26 tables at once, ids as a strided [T, B, M]
     view bitwise equal to a contiguous copy), K1 at the main path's shape
     for its three value types (float32 sums bitwise equal across two runs)
     and the fused edge stage K2 at the same shape (with and without a live
     mask and the charges, its vertex state in shared memory and through
     L1/L2, against the eager stage with K1 that it replaced), with times;
  3. ``peel_threshold`` float32 bits, card against CPU and numpy;
  4. P-Bahmani, kernel on against kernel off and the numpy oracle; one K2
     launch a pass, no K1;
  5. CBDS-P and k-core, kernel on against kernel off and the numpy oracles;
     one K2 launch a fixpoint iteration, one K1 launch an augmentation round;
  6. the pruned peel on the planted block, resident on the card: plan, the
     resident prep equal to the host prep field for field (kernels on and
     off), pruned with kernels on and off, unpruned, the host path, the
     numpy oracle; launches a query: K2 one a pass (pass 0 included) and a
     plan iteration, K1 three (the plan's, the prep's and the bucket's
     degrees), K3 two and K4 three (the prep's and the ladder's); every bucket rung K2 sees is dst-sorted; wall times
     split into plan, resident prep, bucket peel and merge, the host path's
     host prep, host half and upload timed once more for the record, and
     the query profiled;
  7. K3 and K4 at the pruned path's own inputs against their plain versions
     and one PyTorch call each, with times (K3 at both callers' masks and at
     the ladder's [8,388,608] bool edge mask; K3 and K4 one launch a call,
     their host time a call);
  8. the pruned peel on the RMAT graph, where pass 0 leaves more lanes than
     the largest bucket: the resident prep decides it after its pass 0 and
     before any K3 or K4 launch, and the query falls back to the unpruned
     peel, equal triple, one K2 launch a pass and a plan iteration plus the
     prep's pass 0;
  9. refinement: ``pbahmani(refine_rounds=3)`` and ``refine`` with the
     kernel on and off (one K2 launch a pass), and each round against
     ``refine_round_np``;
 10. DCN-v2 at full width through ``launch.steps.build_step``: 8 serve_p99
     requests (B = 512), one serve_bulk batch (B = 262,144) and one
     retrieval_cand query (1,000,448 candidates), K5 launches counted; kernel
     on against the plain path on the same module (bags and logits) and the
     bags of 64 rows against a float64 numpy oracle, no sort of the bag ids;
     step times kernel on and off, the split into bag ids, K5, cross and
     MLP; K5 at the serve_bulk shape (on the ids' [T, B, M] view) against its
     plain version and ``F.embedding_bag``, bitwise equal across runs, beside
     the gather ceiling (``embed.gather_ceiling``: the same rows read with no
     bag structure, table by table, in pairs, interleaved, on a contiguous
     copy of the ids, and in pairs with K5's stores) and the transposing copy
     it no longer needs; K5 at serve_p99 with its bound and where the
     wrapper's host time goes;
 11. the streaming ``DeltaEngine`` on a fraud pipeline's resident graph,
     ``planted_dense(2**18, 1024, 16 / 2**18, 0.9, seed=0)`` in an engine of
     ``capacity=1 << 22`` (8,388,608 lanes), ``eps=0.1``, ``refresh_every=4``:
     4 churn batches of 16,384 events (80 % uniform inserts, 20 % deletes of
     present edges) with a pruned query after each, one of them an epoch
     refresh, then a refined query, another after a delete-only batch, and
     ``cbds(rounds=1)``; a second engine with the kernels off fed the same
     batches equals it at every query, and a cold ``pbahmani`` of the
     materialized graph equals it after the first refresh and the last
     batch; K2 one launch a pass and a plan iteration, K1 two a pruned query
     (three with a plan), K3 two, K4 three; the lanes dst-sorted after every
     query; zero audited steady recompiles; ingest, re-sort, query, refresh,
     refined-query and cbds times, with a sync; the certified skip on the
     card at a tiny stream;
 12. the fused multi-tenant service, a fraud/spam deployment with one
     tenant a customer's account graph: two ``StreamService(fused=True,
     eps=0.1, refresh_every=4)`` on the card, kernels on and off, fed the
     same traffic. A lane bucket of 32 tenants at 16,384 vertices and
     capacity 65,536 (131,072 lanes each, 4,194,304 in the stack; 16 hold a
     colluding block, ``planted_dense(2**14, 128, 6 / 2**14, 0.9, seed=i)``,
     pruned; 16 hold 3n uniform pairs, unpruned) and a dense bucket of 64
     tenants at 512 vertices (``[64, 512, 512]`` float32 adjacency); 4 rounds
     of ``ingest_many`` (``bench_tenants.py``'s mixed batches, 512 / 128
     events a tenant), each followed by a coalesced flush of every tenant's
     ``submit_density`` and ``top_k_densest(10)``, then one fixed-round
     refined ``query_group`` a bucket. Kernel on == off at every answer, ==
     a solo ``DeltaEngine`` fed the same stream (every lane-bucket tenant,
     four dense ones), == a cold ``pbahmani`` after the last round; in every
     flush one launch of K2's rows entry a batched pass whatever the group
     size, no tenant's pass on the single-row K2 (its launches there are the
     plans' k-core iterations), K1's rows entry once a prep and a bucket peel,
     K3 and K4 once a compacted row; every row dst-sorted after its flush;
     no error response (the service's fallback watched); no library load
     or graph capture after the first round. Times with a sync: ingest_many,
     each flush, top_k, the refined flushes; the 32 lane-bucket tenants
     queried one by one through solo engines against one ``query_group``
     (queries a second), both profiled; K2's and K1's rows entries on their
     own at the lane bucket's shape and at its first 4 and 16 rows, and at
     131,072 vertices a row and at the least V past the shared-memory budget
     (``peel.ROWS_SHARED_STATE_BYTES``; ``[8, 524288]`` random lanes), each
     checked against its plain version, with ``device_ms`` (CUDA-graph
     replay), ``flushed_ms`` (the same after a 256 MB read evicts the L2),
     the split by kernel and memset (torch.profiler), the one-row kernel
     over the same lanes flattened (keys r*(V+1)+id) as a diagnostic twin
     with its split, ptxas' registers and spills of every rows kernel, and
     each wrapper's host time a call;
 13. the sharded tier (``core/distributed.py``) on ``torch.distributed``. World
     1, a real NCCL group of one rank (file rendezvous, no network):
     ``pbahmani_distributed`` on the RMAT graph at eps 0.1 and 0 and
     ``cbds_distributed``, equal to phases 4 and 5 (coreness too), one K2
     launch and one collective a pass (and K1 and one collective for the
     degrees); phase 11's engine with ``sharded=True`` and a warm twin
     (``pruned=False``) through its seed and first 4 batches, a pruned, warm,
     fixed-round refined and ``cbds`` query after each, equal to phase 11's
     answers and to a single-device engine; phase 12's lane bucket cut to 8
     tenants through ``StreamService(fused=True, sharded=True)`` for 2 rounds
     and a refined flush, equal to ``StreamService(fused=True)``, one
     ``[G, V + 1]`` collective a batched pass. World 2, a gloo group with
     both ranks on the one card (NCCL refuses two ranks on one device),
     spawned: ``pbahmani_distributed`` at eps 0.1 and the stream's seed and 2
     batches, both ranks equal to world 1, under a time limit. Wall times
     (median of 3) and a torch.profiler split of the sharded peel (K2, the
     all-reduce, the host); two ranks on one card give no scaling number.
     Then a second world 2 over ``("data", "model")`` meshes (``phase_mesh``):
     grok-1's MoE layer at published widths (8 experts, top-2, d_model 6,144,
     d_ff 32,768, bfloat16) through ``moe_tp`` over (1, 2), each rank every
     expert's d_ff 16,384 slice (4.83 GB), and deepseek-v3's (256 experts,
     top-8, one shared, d_model 7,168, d_ff 2,048, capacity factor 1.25)
     through ``moe_ep``, each rank 128 experts (11.3 GB), on 1 x 2,048
     seeded tokens, each rank drawing only its shard from seeded generators:
     equal to world 1 (``mesh=None``, in this process) and to ``moe_dense``
     normwise within 1e-2, aux within rtol 0.2, no dropped replica (16,384
     replicas, 10,240 a peer), bitwise repeatable, three all-to-alls a
     ``moe_ep`` layer and one sum over "model" a ``moe_tp`` layer (from
     ``collective.calls``); ``vp_segment_sum`` on ogbn-products' 123.7 M
     lanes (phase 16's graph, ``partition_by_dst_block``, seeded ``[E, 16]``
     float32 messages) over (2, 1) (two node blocks, no sum) and (1, 2) (one
     block, the sum over "model"), K1 once on each rank: equal to K1 off,
     the gathered blocks equal to world 1's ``segment_sum`` within 1e-5,
     bitwise repeatable; the walls of each collective at these sizes, of
     the MoE layers at world 1 and 2, and K1's per-rank ``device_ms``
     against its byte bound;
 14. the invariant linter (``repro_torch.analysis``) on the card, in this process
     only: ``src/repro_torch`` under the full catalog with the auditor's live
     providers and this script under RPR401-402, 0 findings each, the
     suppressed count by rule printed; the kernels provider and the libraries
     the run loaded equal to the ``build.load`` sites found statically
     (RPR201); the host syncs of a warm P-Bahmani on the RMAT graph counted
     with ``torch.cuda.set_sync_debug_mode("warn")`` at eps 0.1 (5 passes)
     and 0 (7 passes), the difference in syncs equal to the difference in
     passes (one sync a pass), beside the syncs and passes of CBDS-P,
     three refinement rounds and one more fused flush of phase 12's service;
 15. the training runtime (``optim/``, ``checkpoint/``, ``launch/train.py``). (a)
     DCN-v2 training at ``FULL``'s published widths (``multi_hot=1``, so the
     bag is a gather and K5 is not run) through ``build_step("dcn-v2",
     "train_batch")`` (B = 65,536) and AdamW from random seeded weights: step
     1 held against float64 on the CPU (the loss, each leaf's moments
     normwise, the update recomputed from the card's moments), two
     uninterrupted ``run_training`` loops of 6 steps, bitwise equal, and one
     with async checkpoints every 3 steps (keep 1; a disk too small for two
     checkpoints fails the phase) and failures injected at step 1 (re-init)
     and step 4 (a restore racing the step-3 save): 2 restarts, every final
     parameter, moment and loss bitwise equal; the step time, the update
     against its byte bound, a save's snapshot and write, the restore, and
     the one-hot bag's table gradient by ``F.embedding`` (kept, and held
     against a float64 ``index_add_`` on the CPU), ``index_select`` and
     ``index_select`` in deterministic mode. (b)
     ``peel_with_restarts`` on the RMAT graph at eps 0.1 over an NCCL group
     of one with a failure at pass 2: phase 4's triple bit for bit, K1 once,
     K2 once a pass, one collective for the degrees and one a pass, one
     restore; its wall beside phase 13's ``pbahmani_distributed``;
 16. the GNN zoo (``models/gnn.py``) at the published ``FULL`` widths of the
     GCN, SchNet, EGNN and MACE configs, random seeded weights, seeded
     synthetic graphs (no dataset is read), every forward with K1 on against
     the plain path (index_add_) on the same module, K1 launches counted a
     forward (one a ``_seg`` call, after one stable sort of the edge lanes
     by dst a forward and one of the readout's graph ids), every train
     step on the plain path (no K1). (a) gcn-cora on full_graph_sm's size
     (``Graph.from_edges`` of 10,556 seeded pairs over 2,708 vertices, 1,433
     features): the logits against float64 on the CPU, 30 AdamW steps of
     ``build_step("gcn-cora", "full_graph_sm")``, the loss falling; (b) the
     four configs on the molecule shape (``GraphBatcher(30, 64, 128)``: 3,840
     atoms, 16,384 lanes): one step each, its loss and moments against float64
     on the CPU (normwise), SchNet, EGNN and MACE energies invariant under a
     rotation and EGNN's positions equivariant; (c) gcn-cora at ogb_products'
     size (``Graph.from_edges`` of 61,859,140 seeded uniform pairs over
     2,449,029 vertices, 123.7 M lanes, 100 features): the host's pair, graph
     and batch build times, forward on / off and the train step (median of
     3, peak device memory, profiled); (d) minibatch_lg: a block of 1,024
     seeds, fanout (15, 10), sampled from (c)'s graph (cut: Reddit's 232,965
     vertices and 114.6 M lanes are not built; the block's shape, 169,984
     nodes and 168,960 lanes, depends only on the seeds and the fanout), the
     labels and MACE's readout at the seeds: gcn-cora (602 features) and MACE
     (K1 at D = 1,152), forward on / off and a step each, timed; (e) K1 apart
     from the main path at float32 [E, D], D = 1, 16 and 7 (gcn-cora's
     second layer) over (c)'s lanes, 1, 16, 64 and 1,152 over (d)'s: against
     its plain version, bitwise repeatable, with ``ms``, ``device_ms``,
     ``bound_ms`` and the share of it, ``plain_ms``, ``library_ms``
     (``index_add_``) and the forward's one sort of its edge lanes (ids and
     the int32 ``src`` carried along), then ptxas' registers, shared memory
     and spills of the [E, D] path's kernels; D = 64 and wider over (c)'s
     lanes would hold 32 GB and more a copy and are not run;
 17. the transformer family's serving path (``models/transformer.py``,
     ``launch/serve.py``) at the published widths of the five LM configs in
     bfloat16, random seeded weights (``init_params`` on the card), seeded
     uniform prompts (no tokenizer or checkpoint is read), each model freed
     before the next: qwen2.5-3b at full depth (``serve_batch`` of 4 prompts
     x 2,048 tokens, the flash path, with 32 new tokens; the first 16
     positions decoded from an empty cache against the prefill's logits;
     the prefill_32k kind at batch 1, cut from 32; decode_32k at batch 8, cut
     from 128; long_500k through its 4,096-entry window at cache_len
     524,287; its FULL widths at 2 layers in float32, card against CPU),
     mistral-nemo-12b at full depth (``serve_batch``), phi3-mini's
     decode_32k with its int8 cache at batch 2 (cut from 128) against a
     bfloat16 cache of the same values, deepseek-v3 cut to 4 layers (3 dense
     + 1 MoE of 256 experts; ``serve_batch`` through MLA and the absorbed
     decode, long_500k over the full latent cache, ``moe_ep == moe_dense``
     on 64 tokens) and grok-1 cut to 2 layers (``serve_batch``): two serve
     runs bitwise equal, the first token the argmax of the prefill; prefill
     tokens a second, time to the first token, decode ms a step (median of
     3 after a warm call) against its byte bound (the parameters it reads
     and the valid cache entries once, at 3.35 TB/s), host syncs a step (one
     a MoE layer: its group sizes), one profiled step, peak device memory.
     No kernel of K1-K5 runs on this path: their counts stay 0;
 18. LM training (``phase_lm_train``): qwen2.5-3b at 12 layers, grok-1 at 1
     layer and deepseek-v3's first (dense) layer with MTP through the train kind,
     step 1 twice bitwise, qwen2.5 at 2 layers card against CPU in float32,
     and ``run_training`` with failures and checkpoints in JAX's layout;
 19. ``build_step`` over a mesh (``phase_step_mesh``): world 1 in this
     process, then two gloo ranks on the card (``_step_mesh_rank``), each rank
     drawing only its slices (``init_params(mesh=, specs=)``, one whole leaf
     at a time). The train kind in float32 at published widths: mistral-nemo
     at 2 layers (tp_sp with FSDP, 4 microbatches, 8 x 128 tokens) over (1, 2)
     and (2, 1), qwen2.5 at 2 layers (zero3, 2 x 128) over (2, 1): the loss
     against world 1 (rtol 1e-5), every gradient leaf put together against
     world 1's (1e-4 normwise), the train kind bitwise repeatable (the
     gradient's update, then the step from the same state; mistral-nemo over
     (2, 1) runs its gradient only: its float32 state does not fit twice on
     the card). qwen2.5 at 2
     layers and deepseek-v3 at 4 (MLA, ``moe_ep``) in bfloat16 over (1, 2):
     prefill (the sequence over "model"), its cache moved into decode's
     layout, 8 decode steps teacher-forced by world 1's greedy tokens: the
     logits within 5e-2 normwise (phase 17's bfloat16 gate), greedy tokens
     equal, prefill bitwise repeatable. gcn-cora at ogb_products' size over (2, 1) (node blocks) and
     (1, 2), K1 on each rank (``vp_segment_sum``, 3 launches a step): loss
     and gradients against world 1's plain step, bitwise repeatable. Then
     four gloo ranks over (1, 4): qwen2.5's tp_sp gradient at 2 layers in
     float32, 2 x 2,048 tokens (the flash path), whose 2 key heads do not
     split over 4 ranks: each rank computes its sequence block of every
     head (the reference's ``act4`` under ``sp``), against world 1 at the
     same gates. Every train case's attention FLOPs a rank (its forward,
     from the shapes of each call) are world 1's over the mesh's size
     (within 2 %);
 20. DCN-v2 over a mesh (``phase_dcn_mesh``): first the dry run
     (``launch.dryrun.run_cell``) of dcn-v2's four cells, gcn-cora's
     full_graph_sm and qwen2.5's decode_32k on both production meshes, and
     of dcn-v2's train_batch at (1, 2), on the meta device; then world 1 in
     this process and two gloo ranks on the card (``_dcn_mesh_rank``), each
     drawing the whole seeded tables and keeping its rows. FULL's widths
     (26 tables x 1,000,000 x 16 float32): serve_bulk (262,144 rows) at
     multi_hot=4 with K5 on each rank's rows over (1, 2) and (2, 1), one K5
     launch a rank a call, K5 on a rank's half tables against its plain
     version and timed beside world 1's; serve_p99 and retrieval_cand
     (1,000,448 candidates) at multi_hot=1 over (1, 2), the one-hot bags
     bitwise equal to world 1's; train_batch (65,536 rows, AdamW) over (2, 1)
     and (1, 2), two steps: logits and scores within 1e-5 normwise of world
     1, the loss within 1e-5, each gradient and parameter leaf put together
     within 1e-4 normwise, the step bitwise repeatable; the dry run's
     ``peak_bytes`` printed beside rank 0's measured peak of the same step;
 21. a JSON line of every kernel, then the card's name and power limit, then
     the result line ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result line. It also exits non-zero where there is no CUDA device, or when
the ``repro_torch`` package is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SCALE = 19
EDGE_FACTOR = 16
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REPLACES = {"segment_sum_sorted": "src/repro/kernels/segsum.py:118",
            "peel_edges": "src/repro/kernels/ops.py:208 (peel_update; reaches "
                          "pl.pallas_call through K1 at ops.py:200)",
            "prefix_sum": "src/repro/kernels/compact.py:73",
            "stream_compact": "src/repro/kernels/compact.py:88",
            "segment_embed": "src/repro/kernels/ops.py:254 (reaches pl.pallas_call "
                             "through K1 at ops.py:251)",
            "peel_edges_rows": "src/repro/stream/delta.py:481 _batched_warm_peel_jit (and "
                               "core/prune.py:533, refine/loads.py:211: the vmapped pass, "
                               "pl.pallas_call through K1 at kernels/segsum.py:118)",
            "segment_sum_rows": "src/repro/core/prune.py:533 _batched_bucket_peel_jit (the "
                                "vmapped bucket degrees, pl.pallas_call at "
                                "kernels/segsum.py:118)",
            "segment_sum_sorted_ed": "src/repro/kernels/segsum.py:118 (K1's float32 [E, D] "
                                     "sums, reached from models/gnn.py:39 _seg through "
                                     "kernels/ops.py:162 and :157)"}
SOURCES = {"segment_sum_sorted": "src/repro_torch/csrc/segsum.cu",
           "peel_edges": "src/repro_torch/csrc/peel.cu",
           "prefix_sum": "src/repro_torch/csrc/compact.cu",
           "stream_compact": "src/repro_torch/csrc/compact.cu",
           "segment_embed": "src/repro_torch/csrc/embed.cu",
           "peel_edges_rows": "src/repro_torch/csrc/peel.cu",
           "segment_sum_rows": "src/repro_torch/csrc/segsum.cu",
           "segment_sum_sorted_ed": "src/repro_torch/csrc/segsum.cu"}
EMBED_TOL = (1e-5, 1e-6)     # K5 bags: float32 sums in another order (rtol, atol)
LOGIT_TOL = (1e-4, 1e-5)     # logits and scores: float32 products in another order
PLANTED = dict(n=2**19, clique_size=2048, p_background=16 / 2**19, p_planted=0.9, seed=0)
# phase 11: a fraud pipeline's resident graph (a 1,024-vertex colluding block
# in 262,144 accounts), 8,388,608 lanes, and its churn batches
STREAM_GRAPH = dict(n=2**18, clique_size=1024, p_background=16 / 2**18, p_planted=0.9, seed=0)
STREAM_ENGINE = dict(eps=0.1, capacity=1 << 22, refresh_every=4)
STREAM_BATCHES = 4   # depth cut for the smoke's time limit
STREAM_EVENTS = 16384   # a batch: 80 % uniform inserts, 20 % deletes of present edges
# phase 12: a multi-tenant fraud/spam deployment (one tenant a customer's
# account graph) through the fused service: a lane bucket of 32 tenants at
# 16,384 vertices (131,072 lanes each; 16 with a colluding block, pruned, 16
# uniform) and a dense bucket of 64 tenants at 512 vertices
FUSED_COO = dict(n=2**14, capacity=1 << 16, tenants=32, planted=16, clique=128,
                 p_background=6 / 2**14, p_planted=0.9, events=512)
FUSED_DENSE = dict(n=512, capacity=2048, tenants=64, seed_pairs=1536, events=128)
FUSED_ROUNDS = 4
# The JAX package's numpy oracles on rmat(19, 16, seed=0): (passes, |S|) of
# pbahmani_np per eps, and (k*, m_v, m_e) of kcore_np (minutes on a host
# CPU, too slow to rerun here; the same oracle is rerun at scale 15 below).
EXPECTED_PEEL = {19: {0.1: (5, 5204), 0.0: (7, 1185)}}
EXPECTED_CORE = {19: (186, 5036, 1549727)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` over ``iters`` calls, after a warm
    call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture_graph(fn):
    """``fn()`` captured once in a CUDA graph (after a warm call on a side
    stream) and replayed once. ``fn`` must not synchronise."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: the call captured once in a CUDA graph
    and replayed ``iters`` times between two CUDA events, so the host's
    launch overhead (Python, ctypes, allocation) is not in it. ``fn`` must
    not synchronise."""
    import torch

    graph = capture_graph(fn)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one ``fn()`` in microseconds over ``iters`` calls
    with no synchronisation between them: what the caller's thread spends
    on the call (checks, allocation, launch), not the card's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def wall_s(fn, runs: int) -> list[float]:
    import torch

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def profile_call(fn, top: int | None = 6, warm: bool = True, cpu: bool = True) -> dict:
    """Where one ``fn()`` call's time goes on the card, by torch.profiler:
    the device's busy time (the union of its kernel, memset and copy
    intervals), its idle share of the profiled window (host clock, so the
    profiler's own overhead counts as idle), and the busiest kernels. The
    ranges that ``obs`` spans name on the device timeline (``obs:<name>``)
    are annotations, not activity, and are left out. Empty when the
    profiler records no device activity. ``warm=False`` skips the warm call
    before the profiled one (for a call already warm, seconds long);
    ``cpu=False`` records the device's activity only (a train step's
    million host ops take a minute to read back)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.name.startswith("obs:"):
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    if not spans:
        return {}
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(window_ms=window_us / 1e3, busy_ms=busy / 1e3,
                idle_share=1.0 - busy / window_us, device_launches=len(spans),
                top_ms={k[:60]: t / 1e3 for k, t in top})


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class CallCount:
    """Counts the calls of ``module.name`` while active (a wrapper put in
    place and taken out again): the passes and fixpoint iterations that
    reach the edge stage, to hold K2's launch count against."""

    def __init__(self, module, name: str):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class CallLog(CallCount):
    """CallCount that also keeps each call's arguments and result."""

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        self.calls = []

        def logged(*a, **k):
            self.n += 1
            out = self.real(*a, **k)
            self.calls.append((a, k, out))
            return out

        setattr(self.module, self.name, logged)
        return self


def edge_stage_calls():
    """Counters of the edge-stage calls made by P-Bahmani's pass and by the
    k-core fixpoint (each of which is one K2 launch with the kernel on)."""
    import importlib

    return tuple(CallCount(importlib.import_module(f"repro_torch.core.{m}"), "peel_edges")
                 for m in ("pbahmani", "kcore"))


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------
def kernel_cases(device: str, seed: int = 0):
    """(name, values, seg_ids, num_segments, out_dtype, tol) on ``device``:
    the cases of tests/test_kernels.py plus negative ids. tol None means
    exact equality."""
    import torch

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def sorted_ids(e, v):
        return np.sort(rng.integers(0, v, e)).astype(np.int32)

    cases = []
    for e, d, v in [(64, 0, 16), (1000, 33, 300), (512, 128, 256),
                    (2048, 16, 1000), (513, 7, 100), (100, 200, 50)]:
        vals = rng.normal(size=(e, d) if d else (e,)).astype(np.float32)
        cases.append((f"shape e={e} d={d} v={v}", t(vals), t(sorted_ids(e, v)), v,
                      torch.float32, 1e-5))
    seg = sorted_ids(500, 64)
    cases.append(("bf16 [500,8]", t(rng.normal(size=(500, 8)).astype(np.float32)).to(torch.bfloat16),
                  t(seg), 64, torch.float32, 2e-2))
    ints = rng.integers(0, 3, (500, 8)).astype(np.int32)
    cases.append(("int32 [500,8] -> f32", t(ints), t(seg), 64, torch.float32, None))
    cases.append(("int32 [500,8] -> i32", t(ints), t(seg), 64, torch.int32, None))
    cases.append(("sentinel padding", t(np.ones(6, np.float32)),
                  t(np.array([0, 1, 1, 7, 8, 100], np.int32)), 7, torch.float32, None))
    cases.append(("all sentinel", t(np.ones(700, np.float32)),
                  t(np.full(700, 1 << 20, np.int32)), 32, torch.float32, None))
    cases.append(("one segment straddles", t(np.ones(1537, np.float32)),
                  t(np.zeros(1537, np.int32)), 4, torch.float32, None))
    hub = np.r_[np.zeros(3, np.int32), np.full(50_000, 1, np.int32), np.full(7, 2, np.int32)]
    cases.append(("hub row of 50000 lanes, bool -> i32", t(rng.random(hub.size) < 0.5),
                  t(hub), 3, torch.int32, None))
    dup = np.sort(np.r_[np.full(510, 3), np.full(5, 4), np.full(509, 5)]).astype(np.int32)
    cases.append(("duplicates at run boundaries", t(np.ones(dup.size, np.float32)),
                  t(dup), 8, torch.float32, None))
    neg = np.sort(np.r_[rng.integers(-50, 0, 40), rng.integers(0, 30, 300)]).astype(np.int32)
    cases.append(("negative ids", t(rng.normal(size=neg.size).astype(np.float32)),
                  t(neg), 30, torch.float32, 1e-5))
    cases.append(("negative ids, bool -> i32", t(rng.random(neg.size) < 0.5), t(neg), 30,
                  torch.int32, None))
    return cases


def compare(out, exp, tol) -> float:
    import torch

    check(out.dtype == exp.dtype and out.shape == exp.shape,
          f"kernel gave {out.dtype} {tuple(out.shape)}, plain {exp.dtype} {tuple(exp.shape)}")
    if tol is None:
        check(torch.equal(out, exp), "kernel and plain version differ (exact case)")
        return float((out.double() - exp.double()).abs().max()) if out.numel() else 0.0
    rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
    check(torch.allclose(out, exp, rtol=rtol, atol=atol),
          f"kernel and plain version differ beyond rtol={rtol}, atol={atol}")
    return float((out - exp).abs().max()) if out.numel() else 0.0


def phase_kernels(g, device: str) -> tuple[dict, dict]:
    import torch

    from repro_torch.graphs.convert import to_device
    from repro_torch.kernels import ops, ref, segsum

    max_err = 0.0
    for name, vals, seg, v, out_dtype, tol in kernel_cases(device):
        out = segsum.segment_sum_sorted(vals, seg, num_segments=v, out_dtype=out_dtype)
        exp = ref.segment_sum_ref(vals, seg, v, out_dtype)
        torch.cuda.synchronize()
        err = compare(out, exp, tol)
        max_err = max(max_err, err)
        log(f"  K1 {name}: ok (max abs err {err:g}, tol {tol or 'exact'})")

    # presorted=False sorts first and counts it
    rng = np.random.default_rng(9)
    seg_u = torch.from_numpy(rng.integers(0, 99, 777).astype(np.int32)).to(device)
    vals_u = torch.from_numpy(rng.normal(size=(777, 12)).astype(np.float32)).to(device)
    before = ops.unsorted_fallback_count
    out = ops.segment_sum(vals_u, seg_u, num_segments=99, presorted=False)
    max_err = max(max_err, compare(out, ref.segment_sum_ref(vals_u, seg_u, 99), 1e-5))
    check(ops.unsorted_fallback_count == before + 1, "unsorted fallback not counted")
    log("  K1 presorted=False: ok, counted")

    # the main path's shape: dst-sorted lanes of the graph, 0/1 lanes
    src_s, dst_s = to_device(g, device, sorted=True)
    e, v = dst_s.shape[0], g.n_nodes
    lane_rng = np.random.default_rng(1)
    fail = torch.from_numpy(lane_rng.random(e) < 0.5).to(device)
    fail_i32 = fail.to(torch.int32)
    fail_f32 = fail.to(torch.float32)
    results = {}
    for label, vals, out_dtype in [("bool -> int32 (peel_delta)", fail, torch.int32),
                                   ("int32 -> int32", fail_i32, torch.int32),
                                   ("float32 -> float32", fail_f32, torch.float32)]:
        out = segsum.segment_sum_sorted(vals, dst_s, num_segments=v, out_dtype=out_dtype)
        exp = ref.segment_sum_ref(vals, dst_s, v, out_dtype)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(out, exp, None))
        ms = time_ms(lambda: segsum.segment_sum_sorted(vals, dst_s, num_segments=v,
                                                       out_dtype=out_dtype))
        plain = time_ms(lambda: ref.segment_sum_ref(vals, dst_s, v, out_dtype))
        # yardstick: one index_add_ into V+1 rows over ids already clamped,
        # with values in the accumulator's type (index_add_ takes no bool)
        acc = torch.zeros(v + 1, dtype=out_dtype, device=device)
        ids = dst_s.clamp(max=v)
        vals_lib = vals.to(out_dtype)
        lib = time_ms(lambda: acc.index_add_(0, ids, vals_lib))
        dev = graph_ms(lambda: segsum.segment_sum_sorted(vals, dst_s, num_segments=v,
                                                         out_dtype=out_dtype))
        n_bytes = e * 4 + e * vals.element_size() + v * out.element_size()
        b, by = bound_ms(n_bytes, e)
        results[label] = dict(ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
                              bound_ms=b, bound_by=by)
        log(f"  K1 main shape E={e} V={v} {label}: exact; kernel_ms={ms:.6f} "
            f"device_ms={dev:.6f} "
            f"plain_ms={plain:.6f} library_ms={lib:.6f} bound_ms={b:.6f} ({by})")

    # float32 sums of random values: bitwise equal across two runs
    noise = torch.from_numpy(lane_rng.normal(size=e).astype(np.float32)).to(device)
    a = segsum.segment_sum_sorted(noise, dst_s, num_segments=v)
    b = segsum.segment_sum_sorted(noise, dst_s, num_segments=v)
    torch.cuda.synchronize()
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          "K1 float32 sums differ between two runs")
    # against the exact sums, within 1e-6 of each row's sum of |values| (the
    # plain version's atomic adds change their order from run to run)
    exact = ref.segment_sum_ref(noise.double(), dst_s, v, torch.float64)
    scale = ref.segment_sum_ref(noise.double().abs(), dst_s, v, torch.float64)
    err = float((a.double() - exact).abs().max())
    check(bool(((a.double() - exact).abs() <= 1e-6 * scale + 1e-6).all()),
          f"K1 float32 sums stray from the float64 sums by up to {err:g}")
    log(f"  K1 main shape float32 random values: bitwise equal across two runs; max abs "
        f"err {err:g} against float64 (bound 1e-6 * row sum of |values| + 1e-6)")
    return dict(results["bool -> int32 (peel_delta)"], max_abs_err=max_err,
                by_type=results), phase_peel_kernel(src_s, dst_s, v, device)


def inline_stage_k1(src, dst, active, failed, n):
    """The edge stage as the main path ran it before K2: the elementwise ops
    and gathers in eager PyTorch, then K1 for the degree decrement."""
    import torch

    from repro_torch.kernels import segsum

    src_c, dst_c = src.clamp(max=n - 1), dst.clamp(max=n - 1)
    live = ((src < n) & (dst < n) & active.index_select(0, src_c)
            & active.index_select(0, dst_c))
    fail_s = failed.index_select(0, src_c) & live
    fail_d = failed.index_select(0, dst_c) & live
    return (segsum.segment_sum_sorted(fail_s, dst, num_segments=n, out_dtype=torch.int32),
            (fail_s | fail_d).sum(dtype=torch.int32))


def phase_peel_kernel(src_s, dst_s, v: int, device: str) -> dict:
    """K2 at the main path's shape against its plain version (with and
    without a live mask and the charges), with times: the shared-memory and
    the L1/L2 state paths, the stage it replaced (eager ops + K1), the
    scatter tier and one gather + ``index_add_``."""
    import torch

    from repro_torch.core import dispatch
    from repro_torch.kernels import ops, peel, ref

    e = dst_s.shape[0]
    rng = np.random.default_rng(2)
    active = torch.from_numpy(rng.random(v) < 0.9).to(device)
    failed = active & torch.from_numpy(rng.random(v) < 0.3).to(device)
    max_err = 0
    for act in (active, None):
        for charge in (False, True):
            got = peel.peel_edges_sorted(src_s, dst_s, act, failed, n_nodes=v, charge=charge)
            want = ref.peel_edges_ref(src_s, dst_s, act, failed, v, charge)
            torch.cuda.synchronize()
            check(all(x.dtype == torch.int32 for x in got),
                  "K2 returns a tensor that is not int32")
            err = max(int((x.long() - w.long()).abs().max()) for x, w in zip(got, want))
            max_err = max(max_err, err)
            check(err == 0, f"K2 (active={'mask' if act is not None else None}, "
                  f"charge={charge}) differs from peel_edges_ref by up to {err}")
    got, want = (ops.peel_update(src_s, dst_s, failed, n_nodes=v),
                 ref.peel_update_ref(src_s, dst_s, failed, v))
    err = int((got.long() - want.long()).abs().max())
    max_err = max(max_err, err)
    check(err == 0, f"peel_update (K2, active=None) differs from its plain version by {err}")
    check(torch.equal(inline_stage_k1(src_s, dst_s, active, failed, v)[0],
                      peel.peel_edges_sorted(src_s, dst_s, active, failed, n_nodes=v)[0]),
          "the eager stage with K1 differs from K2")
    log(f"  K2 main shape E={e} V={v}: == peel_edges_ref with a live mask and with "
        f"active=None, with and without charges; peel_update == its plain version")

    def k2(charge=False):
        return peel.peel_edges_sorted(src_s, dst_s, active, failed, n_nodes=v, charge=charge)

    ms = time_ms(k2)
    dev = graph_ms(k2)
    dev_charge = graph_ms(lambda: k2(True))
    # the packed state read through L1/L2, as vertex counts past the
    # shared-memory limit take it
    saved = peel.SHARED_STATE_BYTES
    peel.SHARED_STATE_BYTES = 0
    try:
        check(all(torch.equal(x, w) for x, w in zip(k2(True), ref.peel_edges_ref(
            src_s, dst_s, active, failed, v, True))), "K2 (state through L1/L2) differs")
        dev_l2, dev_l2_charge = graph_ms(k2), graph_ms(lambda: k2(True))
    finally:
        peel.SHARED_STATE_BYTES = saved
    plain = time_ms(lambda: ref.peel_edges_ref(src_s, dst_s, active, failed, v))
    scatter = time_ms(lambda: dispatch.peel_edges(src_s, dst_s, active, failed, v, False))
    before = time_ms(lambda: inline_stage_k1(src_s, dst_s, active, failed, v))
    before_dev = graph_ms(lambda: inline_stage_k1(src_s, dst_s, active, failed, v))
    # yardstick: one gather and one index_add_ (delta alone, no live mask)
    acc = torch.zeros(v + 1, dtype=torch.int32, device=device)
    ids = dst_s.clamp(max=v)
    src_c = src_s.clamp(max=v - 1)
    lib = time_ms(lambda: acc.index_add_(0, ids, failed[src_c].to(torch.int32)))
    # src and dst read once, active and failed once, delta and removed written once
    b, by = bound_ms(e * 8 + v * 2 + v * 4 + 4, 8 * e)
    b_charge = bound_ms(e * 8 + v * 2 + v * 8 + 4, 10 * e)[0]
    log(f"  K2 main shape: kernel_ms={ms:.6f} device_ms={dev:.6f} (charge {dev_charge:.6f}; "
        f"state through L1/L2 {dev_l2:.6f}, charge {dev_l2_charge:.6f}) "
        f"plain_ms={plain:.6f} library_ms={lib:.6f} (gather + index_add_) bound_ms={b:.6f} "
        f"({by}; charge {b_charge:.6f}); the stage it replaced (eager ops + K1) "
        f"{before:.6f} ms a call, {before_dev:.6f} on the card; scatter tier {scatter:.6f}")
    return dict(ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib, bound_ms=b,
                bound_by=by, max_abs_err=float(max_err), device_ms_charge=dev_charge, bound_ms_charge=b_charge,
                device_ms_l2_state=dev_l2, device_ms_l2_state_charge=dev_l2_charge,
                eager_plus_k1_ms=before, eager_plus_k1_device_ms=before_dev,
                scatter_ms=scatter, state_bytes=peel.load_library().peel_state_bytes(v))


# ---------------------------------------------------------------------------
# phase 3: peel_threshold bits
# ---------------------------------------------------------------------------
def phase_threshold(device: str, n: int = 4096) -> None:
    import torch

    from repro_torch.core.density import peel_threshold

    rng = np.random.default_rng(3)
    n_e = rng.integers(0, 1 << 24, n).astype(np.int32)
    n_v = rng.integers(0, 1 << 22, n).astype(np.int32)
    for eps in [0.0, 0.05, 0.1, 0.5, 1e-3, 0.3333333333333333, 2.0]:
        cpu = peel_threshold(torch.from_numpy(n_e), torch.from_numpy(n_v), eps)
        dev = peel_threshold(torch.from_numpy(n_e).to(device),
                             torch.from_numpy(n_v).to(device), eps).cpu()
        rho = n_e.astype(np.float32) / np.maximum(n_v.astype(np.float32), np.float32(1))
        ref = np.float32(2.0 * (1.0 + eps)) * rho
        check(np.array_equal(cpu.numpy().view(np.int32), dev.numpy().view(np.int32)),
              f"peel_threshold bits differ between CPU and {device} at eps={eps}")
        check(np.array_equal(cpu.numpy().view(np.int32), ref.view(np.int32)),
              f"peel_threshold bits differ from numpy float32 at eps={eps}")
    log(f"  peel_threshold: {7 * n} cases bit-identical on {device}, CPU and numpy")


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------
def phase_pbahmani(g, device: str, scale: int, timed_runs: int = 3
                   ) -> tuple[int, dict, dict]:
    """Returns (K2 launches, times, the kernel-on triple by eps)."""
    from repro_torch.core import pbahmani, pbahmani_np
    from repro_torch.kernels import peel, segsum

    launches, times, answers = 0, {}, {}
    for eps in (0.1, 0.0):
        t0 = time.perf_counter()
        rho_n, mask_n, passes_n = pbahmani_np(g, eps=eps)
        t_np = time.perf_counter() - t0
        peel.launches = segsum.launches = 0
        rho_k, mask_k, passes_k = pbahmani(g, eps=eps, kernel=True, device=device)
        n_launch = peel.launches
        rho_s, mask_s, passes_s = pbahmani(g, eps=eps, kernel=False, device=device)
        check(n_launch == passes_k, f"eps={eps}: K2 launched {n_launch} times in "
              f"{passes_k} passes")
        check(segsum.launches == 0, f"eps={eps}: the peel launched K1 {segsum.launches} "
              f"times; its edge stage is K2's")
        check(rho_k == rho_s and passes_k == passes_s and np.array_equal(mask_k, mask_s),
              f"eps={eps}: kernel on {rho_k, passes_k} differs from off {rho_s, passes_s}")
        check(passes_k == passes_n and np.array_equal(mask_k, mask_n)
              and abs(rho_k - rho_n) <= 1e-6 * rho_n,
              f"eps={eps}: port {rho_k, passes_k} differs from pbahmani_np {rho_n, passes_n}")
        want = EXPECTED_PEEL.get(scale, {}).get(eps)
        check(want is None or want == (passes_k, int(mask_k.sum())),
              f"eps={eps}: (passes, |S|) = {passes_k, int(mask_k.sum())}, expected {want}")
        launches += n_launch
        answers[eps] = (rho_k, mask_k, passes_k)
        on = wall_s(lambda: pbahmani(g, eps=eps, kernel=True, device=device), timed_runs)
        off = wall_s(lambda: pbahmani(g, eps=eps, kernel=False, device=device), timed_runs)
        times[eps] = dict(kernel_s=statistics.median(on), scatter_s=statistics.median(off),
                          passes=passes_k,
                          profile=profile_call(lambda: pbahmani(g, eps=eps, kernel=True,
                                                                device=device)))
        prof = times[eps]["profile"]
        if prof:  # the profiler slows the host: the busy time against the plain wall too
            prof["idle_share_of_wall"] = 1.0 - prof["busy_ms"] / (times[eps]["kernel_s"] * 1e3)
        log(f"  P-Bahmani eps={eps} profiled: " + (
            f"window {prof['window_ms']:.6f} ms, device busy {prof['busy_ms']:.6f} ms "
            f"(idle share {prof['idle_share']:.4f} of the window, "
            f"{prof['idle_share_of_wall']:.4f} of the wall), {prof['device_launches']} device "
            f"launches; busiest: " + "; ".join(f"{k} {t:.6f}" for k, t in
                                              prof["top_ms"].items())
            if prof else "no device activity recorded (not measured)"))
        log(f"  P-Bahmani eps={eps}: density={rho_k!r} |S|={int(mask_k.sum())} "
            f"passes={passes_k}; on == off == pbahmani_np (numpy {t_np:.2f} s); "
            f"K2 launches={n_launch}; wall median of {timed_runs}: kernel "
            f"{times[eps]['kernel_s']:.6f} s, scatter {times[eps]['scatter_s']:.6f} s")
    return launches, times, answers


def phase_cbds(g, g_small, device: str, scale: int) -> tuple[int, int, dict, tuple]:
    """Returns (K2 launches, K1 launches, times, (cbds_p's dict, coreness))
    of CBDS-P on ``g``."""
    from repro_torch.core import cbds_np, cbds_p, kcore_decompose, kcore_np
    from repro_torch.kernels import peel, segsum

    # numpy oracles at the smaller scale
    core_n = kcore_np(g_small)
    cb_n = cbds_np(g_small, rounds=1)
    for kernel in (True, False):
        core_p = kcore_decompose(g_small, kernel=kernel, device=device)
        cb_p = cbds_p(g_small, rounds=1, kernel=kernel, device=device)
        check(np.array_equal(core_p[0], core_n[0]) and core_p[2:] == core_n[2:]
              and abs(core_p[1] - core_n[1]) <= 1e-6 * core_n[1],
              f"kcore (kernel={kernel}) {core_p[1:]} differs from kcore_np {core_n[1:]}")
        check(cb_p["k_star"] == cb_n["k_star"] and cb_p["n_legit"] == cb_n["n_legit"]
              and np.array_equal(cb_p["member_mask"], cb_n["member_mask"])
              and abs(cb_p["density"] - cb_n["density"]) <= 1e-6 * cb_n["density"],
              f"cbds_p (kernel={kernel}) differs from cbds_np")
    log(f"  small graph |V|={g_small.n_nodes}: kcore and cbds_p (kernel on and off) "
        f"== kcore_np, cbds_np (k*={core_n[2]}, m_v={core_n[3]}, m_e={core_n[4]})")

    peel.launches = segsum.launches = 0
    _, kcore_calls = edge_stage_calls()
    t0 = time.perf_counter()
    with kcore_calls:
        cb_k = cbds_p(g, rounds=1, kernel=True, device=device)
    t_cb_k = time.perf_counter() - t0
    n_cbds, n_k1 = peel.launches, segsum.launches
    check(n_cbds == kcore_calls.n and n_cbds > 0,
          f"CBDS-P launched K2 {n_cbds} times in {kcore_calls.n} fixpoint iterations")
    check(n_k1 == 1, f"CBDS-P rounds=1 launched K1 {n_k1} times, expected one (e_into)")
    t0 = time.perf_counter()
    cb_s = cbds_p(g, rounds=1, kernel=False, device=device)
    t_cb_s = time.perf_counter() - t0
    check(all(np.array_equal(cb_k[f], cb_s[f]) for f in cb_k),
          f"cbds_p kernel on {cb_k['density'], cb_k['k_star']} differs from off "
          f"{cb_s['density'], cb_s['k_star']}")

    peel.launches = 0
    t0 = time.perf_counter()
    core_k = kcore_decompose(g, kernel=True, device=device)
    t_core_k = time.perf_counter() - t0
    n_core = peel.launches
    t0 = time.perf_counter()
    core_s = kcore_decompose(g, kernel=False, device=device)
    t_core_s = time.perf_counter() - t0
    check(np.array_equal(core_k[0], core_s[0]) and core_k[1:] == core_s[1:],
          f"kcore kernel on {core_k[1:]} differs from off {core_s[1:]}")
    check(n_core == n_cbds, f"kcore launched K2 {n_core} times, CBDS-P {n_cbds}")
    want = EXPECTED_CORE.get(scale)
    check(want is None or want == core_k[2:],
          f"(k*, m_v, m_e) = {core_k[2:]}, expected {want}")
    check(cb_k["k_star"] == core_k[2] and cb_k["core_density"] == core_k[1],
          "cbds_p's core phase differs from kcore_decompose")
    prof = profile_call(lambda: cbds_p(g, rounds=1, kernel=True, device=device))
    if prof:  # the profiler slows the host: the busy time against the plain wall too
        prof["idle_share_of_wall"] = 1.0 - prof["busy_ms"] / (t_cb_k * 1e3)
    log(f"  CBDS-P profiled: " + (
        f"window {prof['window_ms']:.6f} ms, device busy {prof['busy_ms']:.6f} ms (idle "
        f"share {prof['idle_share']:.4f} of the window, {prof['idle_share_of_wall']:.4f} "
        f"of the wall), {prof['device_launches']} device launches; "
        f"busiest: " + "; ".join(f"{k} {t:.6f}" for k, t in prof["top_ms"].items())
        if prof else "no device activity recorded (not measured)"))
    times = dict(cbds_kernel_s=t_cb_k, cbds_scatter_s=t_cb_s, kcore_kernel_s=t_core_k,
                 profile=prof,
                 kcore_scatter_s=t_core_s, launches=n_cbds, k1_launches=n_k1)
    log(f"  CBDS-P rounds=1: density={cb_k['density']!r} k*={cb_k['k_star']} "
        f"n_legit={cb_k['n_legit']} |S|={int(cb_k['member_mask'].sum())}; on == off; "
        f"K2 launches={n_cbds} (one a fixpoint iteration), K1 {n_k1}; wall kernel "
        f"{t_cb_k:.6f} s, scatter {t_cb_s:.6f} s")
    log(f"  k-core: max coreness={int(core_k[0].max())} k*={core_k[2]} m_v={core_k[3]} "
        f"m_e={core_k[4]} density={core_k[1]!r}; on == off; K2 launches={n_core}; "
        f"wall kernel {t_core_k:.6f} s, scatter {t_core_s:.6f} s")
    return n_cbds, n_k1, times, (cb_k, core_k[0])


# ---------------------------------------------------------------------------
# phase 2 (K3, K4): the compaction kernels at the cases of the tests
# ---------------------------------------------------------------------------
def phase_compact_cases(device: str) -> float:
    """K3 and K4 against their plain versions (exact) at the cases of
    tests/test_kernels.py, plus a scan whose total passes 2^24 (int32 stays
    exact where the JAX kernel's float32 would not). Returns max abs err."""
    import torch

    from repro_torch.kernels import compact, ref

    rng = np.random.default_rng(4)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    max_err = 0.0
    scans = [(f"int32 e={e}", rng.integers(0, 4, e).astype(np.int32))
             for e in (1, 7, 511, 512, 513, 1500)]
    scans += [("bool ones 3*512+5", np.ones(3 * 512 + 5, bool)),
              ("int32 zeros 513", np.zeros(513, np.int32)),
              ("int32 signed 4194321", rng.integers(-5, 6, 4_194_321).astype(np.int32)),
              ("bool ones 2^24+5 (total past 2^24)", np.ones((1 << 24) + 5, bool))]
    # the one-pass kernel at a thread's and a tile's edges, one tile past a
    # wave of resident blocks, and 2^26 + 3 lanes
    wave = (torch.cuda.get_device_properties(0).multi_processor_count * 8 + 1) * compact.TILE + 5
    for e in (0, 15, 16, 4095, 4096, 4097, 8191, 8192, 8193, wave, (1 << 26) + 3):
        scans += [(f"bool e={e}", rng.random(e) < 0.4),
                  (f"int32 e={e}", rng.integers(-7, 8, e).astype(np.int32))]
    for name, x in scans:
        tx = t(x)
        before = compact.prefix_sum_launches
        out = compact.prefix_sum(tx)
        exp = ref.prefix_sum_ref(tx)
        torch.cuda.synchronize()
        check(compact.prefix_sum_launches == before + (x.size > 0),
              f"K3 {name}: {compact.prefix_sum_launches - before} launches for one call")
        max_err = max(max_err, compare(out, exp, None))
        if name.startswith("bool ones 2^24"):
            check(int(out[-1]) == x.size, f"K3 total {int(out[-1])}, expected {x.size}")
        log(f"  K3 {name}: exact")
    comps = []
    for e, d, out_size, p_live in [(100, 0, 128, 0.5), (1500, 0, 1024, 0.7),
                                   (513, 0, 512, 0.3), (64, 0, 16, 0.9),
                                   (400, 2, 256, 0.6), (300, 0, 64, 0.0),
                                   (300, 0, 512, 1.0), (0, 2, 8, 0.5)]:
        vals = rng.integers(0, 10_000, (e, d) if d else e).astype(np.int32)
        comps.append((f"e={e} d={d} out={out_size} p_live={p_live}", vals,
                      rng.random(e) < p_live, out_size, out_size))
    dst = np.sort(rng.integers(0, 40, 400)).astype(np.int32)
    comps.append(("2-D dst-sorted keeps order",
                  np.stack([rng.integers(0, 40, 400).astype(np.int32), dst], 1),
                  rng.random(400) < 0.6, 256, 256))
    comps.append(("all dead, negative fill", np.arange(300, dtype=np.int32),
                  np.zeros(300, bool), 64, -7))
    tile = compact.TILE  # the one-pass kernel's tiles: edges, several, a long fill tail
    for e, d, out_size, p_live in [(tile - 1, 2, tile, 0.5), (tile, 0, tile, 1.0),
                                   (tile + 1, 2, 2 * tile, 0.5), (37 * tile + 5, 2, 8 * tile, 0.2),
                                   (37 * tile + 5, 0, 3 * tile, 0.9), (5 * tile, 3, 50 * tile, 0.3),
                                   (9 * tile + 1, 0, 9 * tile + 1, 0.0)]:
        vals = rng.integers(-10_000, 10_000, (e, d) if d else e).astype(np.int32)
        comps.append((f"e={e} d={d} out={out_size} p_live={p_live} (tiles of {tile})", vals,
                      rng.random(e) < p_live, out_size, -3))
    for name, vals, live, out_size, fill in comps:
        tv, tl = t(vals), t(live)
        out = compact.stream_compact(tv, tl, out_size=out_size, fill=fill)
        exp = ref.stream_compact_ref(tv, tl, out_size, fill)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(out, exp, None))
        log(f"  K4 {name}: exact")
    return max_err


# ---------------------------------------------------------------------------
# phase 6: the pruned peel on the planted block
# ---------------------------------------------------------------------------
def same_prep(got, want) -> bool:
    """Every field of the resident prep (device tensors) equal to the host
    prep's: the integers, best_d1's bits, the masks, perm where a1 holds,
    the plan and the bucket arrays lane for lane."""
    a1 = got.a1.cpu().numpy()
    return ((got.n_v1, got.n_e1, got.better1, got.observed, got.plan)
            == (want.n_v1, want.n_e1, want.better1, want.observed, want.plan)
            and np.float32(got.best_d1).view(np.int32) == np.float32(want.best_d1).view(np.int32)
            and np.array_equal(a1, want.a1)
            and np.array_equal(got.active0.cpu().numpy(), want.active0)
            and np.array_equal(got.perm.cpu().numpy()[a1], want.perm[want.a1])
            and np.array_equal(got.b_src.cpu().numpy(), want.b_src)
            and np.array_equal(got.b_dst.cpu().numpy(), want.b_dst))


def phase_pruned(g, device: str, timed_runs: int = 3) -> tuple[dict, dict, dict]:
    """Returns (launches by kernel on the pruned main path, times by eps,
    the K3/K4 inputs the main path gave its kernels at eps 0)."""
    import torch

    from repro_torch.core import pbahmani, pbahmani_np, prune
    from repro_torch.graphs.convert import to_device
    from repro_torch.kernels import compact, peel, segsum

    launches = {"peel_edges": 0, "segment_sum_sorted": 0, "prefix_sum": 0,
                "stream_compact": 0}
    times, inputs = {}, {}
    u, v = prune.slot_arrays(g)
    deg = g.degrees().astype(np.int32)
    src, dst = to_device(g, device, sorted=True)
    for eps in (0.1, 0.0):
        t0 = time.perf_counter()
        rho_n, mask_n, passes_n = pbahmani_np(g, eps=eps)
        t_np = time.perf_counter() - t0
        plan = prune.plan_for_graph(g, kernel=True, device=device)
        check(plan == prune.plan_for_graph(g, kernel=False, device=device),
              f"eps={eps}: the plan differs with the kernel on and off")
        pd = prune.prepare_pruned_peel(u, v, deg, g.n_edges, eps, plan)
        check(isinstance(pd, prune.PrunedDispatch),
              f"eps={eps}: pass 0 leaves no bucket-sized subproblem ({pd!r:.80})")
        for kernel in (True, False):
            rd = prune.prepare_pruned_peel_resident(src, dst, g.n_nodes, g.n_edges, eps, plan,
                                                    kernel)
            check(isinstance(rd, prune.PrunedDispatch) and same_prep(rd, pd),
                  f"eps={eps}: the resident prep (kernel={kernel}) differs from the host prep")

        peel.launches = segsum.launches = 0
        compact.prefix_sum_launches = compact.stream_compact_launches = 0
        pass_calls, kcore_calls = edge_stage_calls()
        with pass_calls, kcore_calls:
            on = pbahmani(g, eps=eps, pruned=True, kernel=True, device=device)
        counts = dict(zip(launches, (peel.launches, segsum.launches,
                                     compact.prefix_sum_launches,
                                     compact.stream_compact_launches)))
        n_k2 = counts["peel_edges"]
        check(n_k2 > 0 and (counts["segment_sum_sorted"], counts["prefix_sum"],
                            counts["stream_compact"]) == (3, 2, 3),
              f"eps={eps}: the pruned path launched {counts} (expected K2 > 0, K1 3 for the "
              f"plan's, the prep's and the bucket's degrees, K3 2 and K4 3 a query)")
        # pass 0 runs on the card too: every pass and every fixpoint
        # iteration of the plan is one K2 launch
        check(pass_calls.n == on[2] and n_k2 == pass_calls.n + kcore_calls.n,
              f"eps={eps}: K2 launched {n_k2} times for {on[2]} passes "
              f"({pass_calls.n} edge stages) and {kcore_calls.n} plan iterations")
        for name, n in counts.items():
            launches[name] += n
        off = pbahmani(g, eps=eps, pruned=True, kernel=False, device=device)
        full_on = pbahmani(g, eps=eps, kernel=True, device=device)
        full_off = pbahmani(g, eps=eps, kernel=False, device=device)
        host = prune.pruned_peel_host(u, v, deg, g.n_edges, eps, plan, kernel=True,
                                      device=device)
        for label, other in (("pruned, kernel off", off), ("unpruned, kernel on", full_on),
                             ("unpruned, kernel off", full_off), ("the host path", host)):
            check(np.float32(other[0]).view(np.int32) == np.float32(on[0]).view(np.int32)
                  and other[2] == on[2] and np.array_equal(other[1], on[1]),
                  f"eps={eps}: pruned with kernels {on[0], on[2]} differs from "
                  f"{label} {other[0], other[2]}")
        check(on[2] == passes_n and np.array_equal(on[1], mask_n)
              and abs(on[0] - rho_n) <= 1e-6 * rho_n,
              f"eps={eps}: pruned {on[0], on[2]} differs from pbahmani_np {rho_n, passes_n}")

        # every dst array handed to K2 in one run ascends (checked once per
        # array, on the card), and the K3 and K4 calls' inputs are kept for
        # phase 7
        seen, sorted_rungs, k3_calls, k4_calls = set(), [], [], []
        real_k2, real_k3, real_k4 = peel.peel_edges_sorted, prune.prefix_sum, prune.stream_compact

        def k2_checked(src, dst, active, failed, **kw):
            key = (dst.data_ptr(), dst.numel())
            if key not in seen:
                seen.add(key)
                ok = bool(torch.all(dst[1:] >= dst[:-1]))
                check(ok, f"eps={eps}: a K2 hand-off of {dst.numel()} lanes is unsorted")
                sorted_rungs.append(dst.numel())
            return real_k2(src, dst, active, failed, **kw)

        def k3_kept(x):
            k3_calls.append(x.clone())
            return real_k3(x)

        def k4_kept(values, live, **kw):
            k4_calls.append((values.clone(), live.clone(), kw))
            return real_k4(values, live, **kw)

        peel.peel_edges_sorted, prune.prefix_sum, prune.stream_compact = (
            k2_checked, k3_kept, k4_kept)
        try:
            again = pbahmani(g, eps=eps, pruned=True, kernel=True, device=device)
        finally:
            peel.peel_edges_sorted, prune.prefix_sum, prune.stream_compact = (
                real_k2, real_k3, real_k4)
        check(again[2] == on[2] and np.array_equal(again[1], on[1]), "rerun differs")
        check(len(k3_calls) == 2 and len(k4_calls) == 3,
              f"eps={eps}: {len(k3_calls)} K3 and {len(k4_calls)} K4 calls, expected 2 and 3")
        if eps == 0.0:
            inputs = {"k3_prep": k3_calls[0], "k3_ladder": k3_calls[1],
                      "prep_edge": k4_calls[0], "edge": k4_calls[1], "degree": k4_calls[2]}
        ladder_v, ladder_lanes = int(k4_calls[2][1].sum()), int(k4_calls[1][1].sum())

        # wall times: medians of timed_runs after the warm runs above
        def med(fn):
            return statistics.median(wall_s(fn, timed_runs))

        t_plan = med(lambda: prune.plan_for_graph(g, kernel=True, device=device))
        t_prep = med(lambda: prune.prepare_pruned_peel_resident(
            src, dst, g.n_nodes, g.n_edges, eps, plan, True))
        rd = prune.prepare_pruned_peel_resident(src, dst, g.n_nodes, g.n_edges, eps, plan, True)

        def bucket_peel(kernel):
            return prune._bucket_peel(rd.b_src, rd.b_dst, rd.n_v1, rd.n_e1, float(rd.best_d1),
                                      1, eps, *rd.plan.buckets, kernel)

        t_dev_on, t_dev_off = med(lambda: bucket_peel(True)), med(lambda: bucket_peel(False))
        d_b, m_b, p_b = bucket_peel(True)
        t_merge = med(lambda: prune.merge_pruned_peel_resident(rd, d_b, m_b, p_b))
        merged = prune.merge_pruned_peel_resident(rd, d_b, m_b, p_b)
        check(merged[2] == on[2] and np.array_equal(merged[1], on[1]), "split run differs")
        # the host path, once more for the record: host prep, host half, upload
        host_path = dict(
            host_prep_s=med(lambda: (prune.slot_arrays(g), g.degrees())),
            host_half_s=med(lambda: prune.prepare_pruned_peel(u, v, deg, g.n_edges, eps, plan)),
            upload_s=med(lambda: prune.upload_buckets(pd, device)),
            query_s=med(lambda: prune.pruned_peel_host(u, v, deg, g.n_edges, eps, plan,
                                                       kernel=True, device=device)))
        pruned_s = med(lambda: pbahmani(g, eps=eps, pruned=True, kernel=True, device=device))
        prof = profile_call(lambda: pbahmani(g, eps=eps, pruned=True, kernel=True,
                                             device=device))
        if prof:  # the profiler slows the host: the busy time against the plain wall too
            prof["idle_share_of_wall"] = 1.0 - prof["busy_ms"] / (pruned_s * 1e3)
        times[eps] = dict(
            pruned_kernel_s=pruned_s,
            pruned_scatter_s=med(lambda: pbahmani(g, eps=eps, pruned=True, kernel=False,
                                                  device=device)),
            unpruned_kernel_s=med(lambda: pbahmani(g, eps=eps, kernel=True, device=device)),
            plan_s=t_plan, resident_prep_s=t_prep, bucket_peel_kernel_s=t_dev_on,
            bucket_peel_scatter_s=t_dev_off, merge_s=t_merge, host_path=host_path,
            passes=on[2], n_v1=rd.n_v1, lanes1=2 * rd.n_e1, buckets=list(rd.plan.buckets),
            ladder_vertices=ladder_v, ladder_lanes=ladder_lanes, launches=counts,
            plan_iterations=kcore_calls.n, profile=prof)
        log(f"  pruned eps={eps}: density={on[0]!r} |S|={int(on[1].sum())} passes={on[2]}; "
            f"pruned on == off == unpruned on == off == host path == pbahmani_np "
            f"(numpy {t_np:.2f} s); resident prep == host prep (kernels on and off)")
        log(f"    plan rho_lb={plan.rho_lb!r} k={plan.k} candidates={plan.n_candidates}; "
            f"pass 0 leaves {rd.n_v1} vertices, {2 * rd.n_e1} lanes; buckets "
            f"{rd.plan.buckets}; ladder handed {ladder_v} vertices, {ladder_lanes} lanes")
        log(f"    launches K2={n_k2} ({pass_calls.n} passes + {kcore_calls.n} plan "
            f"iterations) K1={counts['segment_sum_sorted']} K3={counts['prefix_sum']} "
            f"K4={counts['stream_compact']}; K3 inputs {[x.numel() for x in k3_calls]}, K4 "
            f"inputs {[tuple(c[0].shape) for c in k4_calls]}; K2 lane arrays checked sorted "
            f"on the card: {sorted_rungs}")
        log(f"    wall median of {timed_runs}: pruned kernel {pruned_s:.6f} s, pruned scatter "
            f"{times[eps]['pruned_scatter_s']:.6f} s, unpruned kernel "
            f"{times[eps]['unpruned_kernel_s']:.6f} s; split: plan {t_plan:.6f}, resident "
            f"prep {t_prep:.6f}, bucket peel {t_dev_on:.6f} (scatter {t_dev_off:.6f}), merge "
            f"{t_merge:.6f} s; host path for the record: host prep "
            f"{host_path['host_prep_s']:.6f}, host half {host_path['host_half_s']:.6f}, "
            f"upload {host_path['upload_s']:.6f}, whole query {host_path['query_s']:.6f} s")
        log(f"    profiled: " + (
            f"window {prof['window_ms']:.6f} ms, device busy {prof['busy_ms']:.6f} ms (idle "
            f"share {prof['idle_share']:.4f} of the window, {prof['idle_share_of_wall']:.4f} "
            f"of the wall), {prof['device_launches']} device launches; busiest: "
            + "; ".join(f"{k} {t:.6f}" for k, t in prof["top_ms"].items())
            if prof else "no device activity recorded (not measured)"))
    return launches, times, inputs


# ---------------------------------------------------------------------------
# phase 7: K3 and K4 at the pruned path's own inputs
# ---------------------------------------------------------------------------
def phase_compact_timing(inputs: dict) -> dict:
    import torch

    from repro_torch.kernels import compact, ref

    res = {}
    # K3 at its two callers' inputs (the prep's vertex mask, the ladder's
    # bucket mask) and at the [8,388,608] bool mask of the ladder's K4 edge
    # call, the shape of the earlier tables
    for label, x in (("prep", inputs["k3_prep"]), ("ladder", inputs["k3_ladder"]),
                     ("edge_mask", inputs["edge"][1])):
        n = x.shape[0]
        before = compact.prefix_sum_launches
        out = compact.prefix_sum(x)
        exp = ref.prefix_sum_ref(x)
        torch.cuda.synchronize()
        check(torch.equal(out, exp), f"K3 ({label}) differs from its plain version")
        check(compact.prefix_sum_launches == before + 1, f"K3 ({label}) launched "
              f"{compact.prefix_sum_launches - before} times for one call")
        ms = time_ms(lambda: compact.prefix_sum(x))
        plain = time_ms(lambda: ref.prefix_sum_ref(x))
        lib = time_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32))
        # 200 replays: a call of 0.01-0.03 ms is noisy over 20
        dev = graph_ms(lambda: compact.prefix_sum(x), 200)
        lib_dev = graph_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32), 200)
        host = host_us(lambda: compact.prefix_sum(x))
        # the same pass with no look-back (tile-local sums): what the wait costs
        ceiling = graph_ms(lambda: compact.scan_ceiling(x), 200)
        b, by = bound_ms(n * x.element_size() + n * 4, n)
        res[f"prefix_sum_{label}"] = dict(
            ms=ms, device_ms=dev, host_us=host, plain_ms=plain, library_ms=lib,
            library_device_ms=lib_dev, no_look_back_device_ms=ceiling, bound_ms=b,
            bound_by=by, shape=f"[{n}] {str(x.dtype).split('.')[-1]} -> int32")
        log(f"  K3 {label} [{n}] {x.dtype}: exact, one launch; kernel_ms={ms:.6f} "
            f"device_ms={dev:.6f} (without the look-back {ceiling:.6f}) host_us={host:.3f} "
            f"(cumsum device_ms={lib_dev:.6f}) plain_ms={plain:.6f} library_ms={lib:.6f} "
            f"(cumsum) bound_ms={b:.6f} ({by})")
    res["prefix_sum"] = res["prefix_sum_edge_mask"]

    for label in ("prep_edge", "edge", "degree"):
        vals, live, kw = inputs[label]
        out_size, fill = kw["out_size"], kw["fill"]
        k3_before, k4_before = compact.prefix_sum_launches, compact.stream_compact_launches
        out = compact.stream_compact(vals, live, **kw)
        exp = ref.stream_compact_ref(vals, live, out_size, fill)
        torch.cuda.synchronize()
        check(torch.equal(out, exp), f"K4 ({label}) differs from its plain version")
        check((compact.prefix_sum_launches - k3_before,
               compact.stream_compact_launches - k4_before) == (0, 1),
              f"K4 ({label}) launched K3 {compact.prefix_sum_launches - k3_before} and K4 "
              f"{compact.stream_compact_launches - k4_before} times for one call")
        d = 1 if vals.dim() == 1 else vals.shape[1]
        n_live = int(live.sum())

        def library():
            sel = vals[live][:out_size]
            return torch.cat([sel, sel.new_full((out_size - sel.shape[0],) + sel.shape[1:],
                                                fill)])

        check(torch.equal(library(), exp), f"K4 ({label}) library yardstick differs")
        ms = time_ms(lambda: compact.stream_compact(vals, live, **kw))
        plain = time_ms(lambda: ref.stream_compact_ref(vals, live, out_size, fill))
        lib = time_ms(library)
        dev = graph_ms(lambda: compact.stream_compact(vals, live, **kw))
        host = host_us(lambda: compact.stream_compact(vals, live, **kw))
        # bytes this input needs: the mask, the live lanes' values, the output
        b, by = bound_ms(live.numel() + min(n_live, out_size) * d * 4 + out_size * d * 4,
                         live.numel())
        res[f"stream_compact_{label}"] = dict(
            ms=ms, device_ms=dev, host_us=host, plain_ms=plain, library_ms=lib, bound_ms=b,
            bound_by=by,
            shape=f"[{vals.shape[0]}{', %d' % d if vals.dim() == 2 else ''}] -> {out_size}",
            live=n_live, bound_ms_all_values=bound_ms(
                live.numel() + vals.numel() * 4 + out_size * d * 4, live.numel())[0])
        log(f"  K4 {label} call {res[f'stream_compact_{label}']['shape']}, {n_live} live: "
            f"exact, one K4 launch and no K3; kernel_ms={ms:.6f} device_ms={dev:.6f} "
            f"host_us={host:.3f} plain_ms={plain:.6f} library_ms={lib:.6f} "
            f"(values[live] + pad) bound_ms={b:.6f} ({by})")
    return res


# ---------------------------------------------------------------------------
# phase 8: the pruned peel where pass 0 overflows the bucket
# ---------------------------------------------------------------------------
def phase_pruned_fallback(g, device: str) -> tuple[int, int]:
    """Returns (K2 launches, K1 launches) of the pruned queries that fell back."""
    from repro_torch.core import pbahmani, prune
    from repro_torch.graphs.convert import to_device
    from repro_torch.kernels import compact, peel, segsum

    u, v = prune.slot_arrays(g)
    deg = g.degrees().astype(np.int32)
    src, dst = to_device(g, device, sorted=True)
    plan = prune.plan_for_graph(g, kernel=True, device=device)
    n_k2 = n_k1 = 0
    for eps in (0.1, 0.0):
        _, a1, _, _ = prune._pass0_host(deg, g.n_edges, eps)
        lanes1 = 2 * prune._induced_slots(u, v, a1).size
        check(prune.prepare_pruned_peel(u, v, deg, g.n_edges, eps, plan) is None,
              f"eps={eps}: expected the pruned path to fall back on this graph")
        check(prune.prepare_pruned_peel_resident(src, dst, g.n_nodes, g.n_edges, eps, plan,
                                                 True) is None,
              f"eps={eps}: expected the resident prep to fall back on this graph")
        peel.launches = segsum.launches = 0
        compact.prefix_sum_launches = compact.stream_compact_launches = 0
        pass_calls, kcore_calls = edge_stage_calls()
        with pass_calls, kcore_calls:
            got = pbahmani(g, eps=eps, pruned=True, kernel=True, device=device)
        check(compact.prefix_sum_launches == compact.stream_compact_launches == 0,
              "the fallback launched the compaction kernels")
        # the resident prep's pass 0 (one K2 launch, K1 for the degrees)
        # decides the fallback; the unpruned peel then starts from scratch
        check(segsum.launches == 2, f"eps={eps}: the fallback launched K1 {segsum.launches} "
              f"times, expected two (the plan's and the prep's degrees)")
        check(pass_calls.n == got[2] + 1 and peel.launches == got[2] + 1 + kcore_calls.n,
              f"eps={eps}: K2 launched {peel.launches} times for {got[2]} passes, the "
              f"prep's pass 0 and {kcore_calls.n} plan iterations")
        k2, k1 = peel.launches, segsum.launches
        n_k2 += k2
        n_k1 += k1
        want = pbahmani(g, eps=eps, kernel=True, device=device)
        check(got[0] == want[0] and got[2] == want[2] and np.array_equal(got[1], want[1]),
              f"eps={eps}: pruned (fallen back) {got[0], got[2]} differs from unpruned")
        log(f"  rmat pruned eps={eps}: fell back to the unpruned peel: pass 0 leaves "
            f"{int(a1.sum())} vertices and {lanes1} lanes, over the largest bucket "
            f"{plan.bucket_e} (half of next_pow2({g.src.shape[0]})); triple == unpruned "
            f"(density={got[0]!r}, passes={got[2]}); no K3 or K4; K2 launches "
            f"{k2} ({got[2]} passes + the prep's pass 0 + {kcore_calls.n} plan "
            f"iterations), K1 {k1}")
    return n_k2, n_k1


# ---------------------------------------------------------------------------
# phase 9: refinement
# ---------------------------------------------------------------------------
def phase_refine(g, g_small, device: str) -> tuple[int, dict]:
    import dataclasses

    import torch

    from repro_torch.core import pbahmani
    from repro_torch.graphs.convert import to_device
    from repro_torch.kernels import peel
    from repro_torch.refine import refine, refine_round_np
    from repro_torch.refine.loads import _refine_round

    peel.launches = 0
    t0 = time.perf_counter()
    on = pbahmani(g, eps=0.1, refine_rounds=3, kernel=True, device=device)
    t_on = time.perf_counter() - t0
    n_k2 = peel.launches
    check(n_k2 == on[2], f"refinement launched K2 {n_k2} times in {on[2]} passes "
          f"(the seed peel's and three rounds')")
    t0 = time.perf_counter()
    off = pbahmani(g, eps=0.1, refine_rounds=3, kernel=False, device=device)
    t_off = time.perf_counter() - t0
    check(on[0] == off[0] and on[2] == off[2] and np.array_equal(on[1], off[1]),
          f"pbahmani(refine_rounds=3): kernel on {on[0], on[2]} differs from off "
          f"{off[0], off[2]}")
    r_on, r_off = (refine(g, target_gap=-1.0, max_rounds=3, eps=0.1, kernel=k, device=device)
                   for k in (True, False))
    c_on, c_off = r_on.certificate, r_off.certificate
    check((c_on.best_ne, c_on.best_nv, c_on.dual_num, c_on.dual_den)
          == (c_off.best_ne, c_off.best_nv, c_off.dual_num, c_off.dual_den)
          and r_on.history == r_off.history and np.array_equal(r_on.mask, r_off.mask),
          "refine: kernel on and off give different certificates or history")
    log(f"  pbahmani(rmat, eps=0.1, refine_rounds=3): density={on[0]!r} passes={on[2]}; "
        f"on == off; K2 launches={n_k2}; wall kernel {t_on:.6f} s, scatter {t_off:.6f} s")
    log(f"  refine(max_rounds=3): certificate {c_on.best_ne}/{c_on.best_nv} <= rho* <= "
        f"{c_on.dual_num}/{c_on.dual_den}, rel_gap {c_on.rel_gap!r}; on == off, history "
        f"equal over {len(r_on.history)} rounds")

    # where a refinement's time goes: one run from a given seed, with the
    # device rounds and the host certificate (dual_fraction) timed apart
    from repro_torch.refine import engine

    seed = pbahmani(g, eps=0.1, kernel=True, device=device)
    split = {"round_s": 0.0, "dual_host_s": 0.0}
    real_round, real_dual = engine._refine_round, engine.dual_fraction

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out
        return run

    engine._refine_round = timed("round_s", real_round)
    engine.dual_fraction = timed("dual_host_s", real_dual)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine(g, target_gap=-1.0, max_rounds=3, eps=0.1, seed=seed, kernel=True,
               device=device)
        split["total_s"] = time.perf_counter() - t0
    finally:
        engine._refine_round, engine.dual_fraction = real_round, real_dual
    split["other_host_s"] = split["total_s"] - split["round_s"] - split["dual_host_s"]
    log(f"  refine(3 rounds, seed given) {split['total_s']:.6f} s: device rounds "
        f"{split['round_s']:.6f} s (one sync a pass), host certificates "
        f"{split['dual_host_s']:.6f} s, other host (degrees, seed counts, upload, mask) "
        f"{split['other_host_s']:.6f} s")

    # each round's loads and best state against the numpy bit-oracle
    n = g_small.n_nodes
    deg = g_small.degrees().astype(np.int32)
    src, dst = to_device(g_small, device, sorted=True)
    state = (torch.zeros(n, dtype=torch.int32, device=device),
             torch.tensor(0.0, device=device),
             torch.tensor(0, dtype=torch.int32, device=device),
             torch.tensor(0, dtype=torch.int32, device=device),
             torch.zeros(n, dtype=torch.bool, device=device),
             torch.tensor(0, dtype=torch.int32, device=device))
    loads_np, best_np = np.zeros(n, np.int32), (np.float32(0.0), 0, 0, np.zeros(n, bool))
    for r in range(3):
        state = _refine_round(src, dst, torch.from_numpy(deg).to(device),
                              torch.tensor(g_small.n_edges, device=device), *state,
                              n, 0.1, True)
        loads_np, best_np, _ = refine_round_np(g_small.src, g_small.dst, deg,
                                               g_small.n_edges, loads_np, best_np, 0.1)
        check(np.array_equal(state[0].cpu().numpy(), loads_np)
              and np.float32(state[1].item()) == best_np[0]
              and (state[2].item(), state[3].item()) == best_np[1:3]
              and np.array_equal(state[4].cpu().numpy(), best_np[3]),
              f"refine round {r + 1} differs from refine_round_np at |V|={n}")
    log(f"  |V|={n}: 3 refine rounds (kernel on) == refine_round_np, loads and best")
    return n_k2, dict(refine_rounds3_kernel_s=t_on, refine_rounds3_scatter_s=t_off,
                      split=split, certificate=dataclasses.asdict(c_on))


# ---------------------------------------------------------------------------
# phase 2 (K5): the fused gather and segment-sum at the cases of the tests
# ---------------------------------------------------------------------------
def phase_embed_cases(device: str) -> float:
    """K5 against its plain version at the cases of tests/test_kernels.py,
    with invalid ids, empty bags, segment ids past V, the scalar path (D not
    a multiple of 4, a table off a 16-byte boundary) and 26 tables at once.
    Long bags take quarter-integer tables and weights, whose sums are exact
    in any order (tol None); random floats on bags of a few rows take
    EMBED_TOL. Returns max abs err."""
    import torch

    from repro_torch.kernels import embed, ref

    rng = np.random.default_rng(5)
    max_err = 0.0
    for t, n, d, e, v, weighted, invalid, quarters in [
            (1, 50, 16, 1000, 300, True, False, False), (1, 20, 64, 200, 64, False, False, False),
            (1, 100, 8, 64, 8, True, False, False), (1, 50, 16, 1000, 300, True, True, False),
            (1, 30, 7, 500, 40, False, True, False), (1, 10, 16, 5, 400, False, False, False),
            (1, 10, 16, 0, 9, True, False, False), (1, 30, 200, 3000, 50, True, False, True),
            (3, 1000, 16, 20_000, 64, True, True, True),
            (26, 100_000, 16, 4 * 4096, 4096, False, False, False),
            (26, 100_000, 16, 4 * 4096, 4096, True, True, False)]:
        lo, hi = (-n, 2 * n) if invalid else (0, n)
        vals = (rng.integers(-8, 8, (t, n, d)) / 4 if quarters
                else rng.normal(size=(t, n, d))).astype(np.float32)
        tables = torch.from_numpy(vals).to(device)
        gid = torch.from_numpy(rng.integers(lo, hi, (t, e)).astype(np.int32)).to(device)
        seg = np.sort(rng.integers(-3 if invalid else 0, v + 3 if invalid else v, e))
        seg = torch.from_numpy(seg.astype(np.int32)).to(device)
        w = rng.integers(0, 8, (t, e)) / 4 if quarters else rng.random((t, e))
        w = torch.from_numpy(w.astype(np.float32)).to(device) if weighted else None
        if t == 1:
            tables, gid, w = tables[0], gid[0], None if w is None else w[0]
        out = embed.segment_embed_sorted(tables, gid, seg, w, num_segments=v)
        exp = ref.segment_embed_ref(tables, gid, seg, w, v)
        torch.cuda.synchronize()
        tol = None if quarters else EMBED_TOL
        err = compare(out, exp, tol)
        max_err = max(max_err, err)
        log(f"  K5 T={t} R={n} D={d} E={e} V={v} weighted={weighted} invalid={invalid}: "
            f"ok (max abs err {err:g}, {'exact, quarters' if quarters else EMBED_TOL})")
    base = torch.from_numpy(rng.normal(size=40 * 16 + 4).astype(np.float32)).to(device)
    table = base[1:1 + 40 * 16].view(40, 16)
    gid = torch.from_numpy(rng.integers(0, 40, 900).astype(np.int32)).to(device)
    seg = torch.from_numpy(np.sort(rng.integers(0, 100, 900)).astype(np.int32)).to(device)
    err = compare(embed.segment_embed_sorted(table, gid, seg, num_segments=100),
                  ref.segment_embed_ref(table, gid, seg, None, 100), EMBED_TOL)
    log(f"  K5 table off a 16-byte boundary (scalar path): ok (max abs err {err:g})")
    max_err = max(max_err, err)
    # strided ids: the [T, B, M] view of [B, T, M] ids that DCN-v2 passes,
    # bitwise equal to the same lanes in a contiguous [T, B * M] copy
    for b, t, m in [(4096, 26, 4), (999, 5, 3), (300, 3, 1), (77, 2, 9)]:
        ids = torch.from_numpy(rng.integers(-2, 1002, (b, t, m)).astype(np.int32)).to(device)
        tables = torch.from_numpy(rng.normal(size=(t, 1000, 16)).astype(np.float32)).to(device)
        seg = torch.arange(b, dtype=torch.int32, device=device)[:, None].expand(b, m).reshape(-1)
        view = ids.permute(1, 0, 2)
        out = embed.segment_embed_sorted(tables, view, seg, num_segments=b)
        err = compare(out, ref.segment_embed_ref(tables, view, seg, None, b), EMBED_TOL)
        flat = embed.segment_embed_sorted(tables, view.reshape(t, -1).contiguous(), seg,
                                          num_segments=b)
        torch.cuda.synchronize()
        check(torch.equal(out, flat), f"K5 on strided ids [{t}, {b}, {m}] differs from the "
                                      f"same lanes copied contiguous")
        max_err = max(max_err, err)
        log(f"  K5 strided ids [{t}, {b}, {m}] (a view of [{b}, {t}, {m}]): ok (max abs err "
            f"{err:g}), bitwise equal to the contiguous copy")
    return max_err


# ---------------------------------------------------------------------------
# phase 10: DCN-v2 serving and retrieval at full width
# ---------------------------------------------------------------------------
def phase_dcn(device: str, timed_runs: int = 3) -> tuple[int, dict, dict]:
    """Returns (K5 launches on the main path, K5's row at the serve_bulk
    shape, the step times and splits)."""
    import copy
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batches
    from repro_torch.kernels import build, embed, ops, ref
    from repro_torch.launch import build_step
    from repro_torch.models import dcn_init, embedding_bag

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    arch = get_arch("dcn-v2")
    cfg = dataclasses.replace(arch.full, multi_hot=4, kernel=True)  # the two departures
    plain_cfg = dataclasses.replace(cfg, kernel=False)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = dcn_init(cfg, device=device, generator=gen).requires_grad_(False)
    plain = copy.copy(model)   # the same parameters, the plain path
    plain.cfg = plain_cfg
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    steps = {s: build_step("dcn-v2", s, device=device)
             for s in ("serve_p99", "serve_bulk", "retrieval_cand")}
    t0 = time.perf_counter()
    stream = recsys_batches(cfg, steps["serve_p99"].meta["rows"], seed=0)
    requests = [next(stream) for _ in range(8)]
    bulk = next(recsys_batches(cfg, steps["serve_bulk"].meta["rows"], seed=0))
    query = next(recsys_batches(cfg, 1, seed=0))
    query["candidates"] = torch.randn(steps["retrieval_cand"].meta["rows"], cfg.embed_dim,
                                      generator=gen, device=device)
    t_data = time.perf_counter() - t0
    log(f"  {cfg.name}: {cfg.n_sparse} tables x {cfg.table_rows} x {cfg.embed_dim} float32 "
        f"({model.tables.numel() * 4 / 1e9:.3f} GB), d_in {cfg.d_in}, cross "
        f"{cfg.n_cross_layers}, MLP {cfg.mlp}, multi_hot {cfg.multi_hot}; init on the card "
        f"{t_init:.3f} s, batches on the host {t_data:.3f} s")

    # the main path, as a user calls it: host batches through the steps
    embed.launches = 0
    sorts = ops.unsorted_fallback_count
    logits_p99 = [steps["serve_p99"].fn(model, r) for r in requests]
    logits_bulk = steps["serve_bulk"].fn(model, bulk)
    scores = steps["retrieval_cand"].fn(model, query)
    torch.cuda.synchronize()
    n_k5 = embed.launches
    check(n_k5 > 0, "DCN-v2 serving did not launch K5")
    check(n_k5 == 10, f"K5 launched {n_k5} times for 10 embedding_bag calls")
    check(ops.unsorted_fallback_count == sorts,
          f"the bags were sorted {ops.unsorted_fallback_count - sorts} times on the main path")
    shapes = {"serve_p99": (steps["serve_p99"].meta["rows"],),
              "serve_bulk": (steps["serve_bulk"].meta["rows"],),
              "retrieval_cand": (1, steps["retrieval_cand"].meta["rows"])}
    for name, out in (("serve_p99", logits_p99[0]), ("serve_bulk", logits_bulk),
                      ("retrieval_cand", scores)):
        check(tuple(out.shape) == shapes[name] and bool(torch.isfinite(out).all()),
              f"{name}: {tuple(out.shape)} output, finite={bool(torch.isfinite(out).all())}")
    log(f"  main path: 8 serve_p99 requests, 1 serve_bulk batch, 1 retrieval_cand query; "
        f"K5 launches {n_k5}; outputs finite, shapes {list(shapes.values())}")

    # kernel on against the plain path on the same module
    def dev(batch, keys=("dense", "sparse_ids")):
        return {k: torch.as_tensor(batch[k], device=device) for k in keys}

    bulk_dev, query_dev = dev(bulk), dev(query, ("dense", "sparse_ids", "candidates"))
    p99_dev = [dev(r) for r in requests]
    ids_bulk = bulk_dev["sparse_ids"]
    max_err = 0.0
    with torch.inference_mode():
        emb_on = embedding_bag(model.tables, ids_bulk, cfg)
        emb_off = embedding_bag(model.tables, ids_bulk, plain_cfg)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(emb_on, emb_off, EMBED_TOL))
        # float64 numpy oracle on 64 sampled rows
        pick = np.random.default_rng(0).choice(emb_on.shape[0], 64, replace=False)
        ids64 = torch.from_numpy(bulk["sparse_ids"][pick].astype(np.int64)).to(device)
        rows = model.tables[torch.arange(cfg.n_sparse, device=device)[None, :, None], ids64]
        oracle = rows.double().cpu().numpy().sum(axis=2).reshape(64, -1)
        got = emb_on[torch.from_numpy(pick).to(device)].cpu().numpy()
        check(np.allclose(got, oracle, rtol=EMBED_TOL[0], atol=EMBED_TOL[1]),
              "K5 bags differ from the float64 oracle")
        oracle_err = float(np.abs(got - oracle).max())
        for label, on_fn, off_fn in (
                ("serve_p99", lambda: steps["serve_p99"].fn(model, p99_dev[0]),
                 lambda: steps["serve_p99"].fn(plain, p99_dev[0])),
                ("serve_bulk", lambda: steps["serve_bulk"].fn(model, bulk_dev),
                 lambda: steps["serve_bulk"].fn(plain, bulk_dev)),
                ("retrieval_cand", lambda: steps["retrieval_cand"].fn(model, query_dev),
                 lambda: steps["retrieval_cand"].fn(plain, query_dev))):
            on, off = on_fn(), off_fn()
            torch.cuda.synchronize()
            check(torch.allclose(on, off, rtol=LOGIT_TOL[0], atol=LOGIT_TOL[1]),
                  f"{label}: kernel on and the plain path differ beyond {LOGIT_TOL}")
        check(torch.equal(emb_on, embedding_bag(model.tables, ids_bulk, cfg)),
              "K5 bags differ between two runs")
    log(f"  kernel on == plain path: bags (rtol, atol {EMBED_TOL}, max abs err "
        f"{max_err:g}), logits and scores ({LOGIT_TOL}); 64 bags == float64 oracle "
        f"(max abs err {oracle_err:g}); K5 bags equal across runs")

    # step times (batches on the card), kernel on and off
    def med(fn):
        return statistics.median(wall_s(fn, timed_runs))

    times = {}
    for label, batch in (("serve_p99", p99_dev[0]), ("serve_bulk", bulk_dev),
                         ("retrieval_cand", query_dev)):
        fn = steps[label].fn
        fn(model, batch), fn(plain, batch)  # warm
        times[label] = dict(kernel_s=med(lambda: fn(model, batch)),
                            plain_s=med(lambda: fn(plain, batch)),
                            model_flops=steps[label].meta["model_flops"])
        times[label]["tflops_kernel"] = (times[label]["model_flops"]
                                         / times[label]["kernel_s"] / 1e12)
    upload = med(lambda: dev(requests[0]))

    # the split of a serve step (kernel on): what embedding_bag does, piece by
    # piece (bag ids, then K5 on the [T, B, M] view of the ids: no copy, no sort)
    splits = {}
    with torch.inference_mode():
        for label, batch in (("serve_p99", p99_dev[0]), ("serve_bulk", bulk_dev)):
            ids = batch["sparse_ids"]
            b, t = ids.shape[0], cfg.n_sparse

            def bag_ids():
                return torch.arange(b, dtype=torch.int32, device=device)[:, None].expand(
                    b, 4).contiguous().view(-1)

            seg_b, view = bag_ids(), ids.permute(1, 0, 2)
            x0 = torch.cat([batch["dense"], model.embed(ids)], dim=-1)
            x = model.cross_net(x0)
            splits[label] = dict(
                bag_ids_s=med(bag_ids),
                k5_s=med(lambda: embed.segment_embed_sorted(model.tables, view, seg_b,
                                                            num_segments=b)),
                embedding_bag_s=med(lambda: model.embed(ids)),
                cross_s=med(lambda: model.cross_net(x0)),
                mlp_s=med(lambda: model.head(x)),
                step_s=times[label]["kernel_s"])
    for label, t in times.items():
        log(f"  {label}: step median of {timed_runs}: kernel {t['kernel_s']:.6f} s, plain "
            f"{t['plain_s']:.6f} s; {t['model_flops']:.0f} model FLOP, "
            f"{t['tflops_kernel']:.3f} TFLOP/s with the kernel")
    for label, sp in splits.items():
        log(f"  {label} split (kernel on, median of {timed_runs}): "
            + ", ".join(f"{k[:-2]} {v:.6f}" for k, v in sp.items()) + " s")
    log(f"  upload of one serve_p99 request: {upload:.6f} s")

    # K5 at the serve_bulk shape, on the [T, B, M] view of the ids as the main
    # path hands it: its time, its plain version's, F.embedding_bag's, the
    # same lanes copied contiguous, and the gather ceiling on the same ids
    t, r, d = model.tables.shape
    b = ids_bulk.shape[0]
    with torch.inference_mode():
        view = ids_bulk.permute(1, 0, 2)
        flat_ids = view.reshape(t, -1).contiguous()
        seg = torch.arange(b, dtype=torch.int32, device=device)[:, None].expand(b, 4).reshape(-1)
        e = seg.shape[0]

        def k5():
            return embed.segment_embed_sorted(model.tables, view, seg, num_segments=b)

        out = k5()
        exp = ref.segment_embed_ref(model.tables, view, seg, None, b)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(out, exp, EMBED_TOL))
        check(torch.equal(out, k5()), "K5 sums differ between two runs at serve_bulk")
        flat_tables = model.tables.view(t * r, d)
        global_ids = (flat_ids.long() + torch.arange(t, device=device)[:, None] * r).reshape(-1)
        offsets = torch.arange(0, t * e, 4, device=device)

        def library():
            return F.embedding_bag(global_ids, flat_tables, offsets, mode="sum")

        check(torch.allclose(library().view(t, b, d).permute(1, 0, 2), out,
                             rtol=EMBED_TOL[0], atol=EMBED_TOL[1]),
              "F.embedding_bag yardstick differs from K5")
        ms = time_ms(k5)
        dev_ms = graph_ms(k5)
        flat_dev_ms = graph_ms(lambda: embed.segment_embed_sorted(model.tables, flat_ids, seg,
                                                                  num_segments=b))
        copy_ms = graph_ms(lambda: view.reshape(t, -1).contiguous())
        sums = torch.empty_like(out)
        ceiling = {
            "table_major": graph_ms(lambda: embed.gather_ceiling(model.tables, view,
                                                                 tables_a_pass=1)),
            "paired": graph_ms(lambda: embed.gather_ceiling(model.tables, view,
                                                            tables_a_pass=2)),
            "interleaved": graph_ms(lambda: embed.gather_ceiling(model.tables, view,
                                                                 tables_a_pass=t)),
            "table_major_contiguous_ids": graph_ms(
                lambda: embed.gather_ceiling(model.tables, flat_ids, tables_a_pass=1)),
            "paired_with_sums": graph_ms(
                lambda: embed.gather_ceiling(model.tables, view, tables_a_pass=2, out=sums)),
        }
        plain_ms = time_ms(lambda: ref.segment_embed_ref(model.tables, view, seg, None, b),
                           iters=5)
        lib_ms = time_ms(library)
        distinct = int(torch.unique(global_ids).numel())
        # ids and seg read once, each distinct row read once, the sums written once
        b_ms, by = bound_ms(t * e * 4 + e * 4 + distinct * d * 4 + b * t * d * 4, t * e * d)
        all_lanes = bound_ms(t * e * 4 + e * 4 + t * e * d * 4 + b * t * d * 4, t * e * d)[0]

        # K5 at serve_p99: the same, and where the wrapper's host time goes
        p99_view = p99_dev[0]["sparse_ids"].permute(1, 0, 2)
        n_p99 = p99_view.shape[1]
        p99_seg = torch.arange(n_p99, dtype=torch.int32, device=device)[:, None].expand(
            n_p99, 4).reshape(-1)

        def k5_p99():
            return embed.segment_embed_sorted(model.tables, p99_view, p99_seg,
                                              num_segments=n_p99)

        check(torch.allclose(k5_p99(), ref.segment_embed_ref(model.tables, p99_view, p99_seg,
                                                             None, n_p99),
                             rtol=EMBED_TOL[0], atol=EMBED_TOL[1]),
              "K5 differs from its plain version at serve_p99")
        p99_ms = time_ms(k5_p99)
        p99_dev_ms = graph_ms(k5_p99)
        p99_distinct = int(torch.unique(p99_view.reshape(t, -1).long()
                                        + torch.arange(t, device=device)[:, None] * r).numel())
        e99 = p99_seg.shape[0]
        p99_bound = bound_ms(t * e99 * 4 + e99 * 4 + p99_distinct * d * 4 + n_p99 * t * d * 4,
                             t * e99 * d)[0]
        host = dict(
            wrapper_us=host_us(k5_p99),
            check_us=host_us(lambda: embed._check(model.tables, p99_view, p99_seg, None)),
            alloc_us=host_us(lambda: torch.empty((n_p99, t, d), device=device)),
            on_device_us=host_us(lambda: build.on_device(model.tables.device, lambda s: 0)))
    k5 = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
              bound_ms=b_ms, bound_by=by,
              bound_ms_all_lanes=all_lanes, distinct_rows=distinct,
              contiguous_ids_device_ms=flat_dev_ms, transpose_copy_device_ms=copy_ms,
              gather_ceiling_ms=ceiling["table_major"],
              gather_ceiling_interleaved_ms=ceiling["interleaved"],
              gather_ceiling_all_ms=ceiling,
              shape=f"[{t}, {r}, {d}] tables, [{t}, {b}, 4] ids (a view), {b} bags",
              serve_p99_ms=p99_ms, serve_p99_device_ms=p99_dev_ms,
              serve_p99_bound_ms=p99_bound, serve_p99_distinct_rows=p99_distinct,
              serve_p99_host=host, max_abs_err=max_err)
    log(f"  K5 at serve_bulk ({k5['shape']}, {distinct} distinct rows): kernel_ms={ms:.6f} "
        f"device_ms={dev_ms:.6f} (on a contiguous copy of the ids {flat_dev_ms:.6f}; the copy "
        f"{copy_ms:.6f}) plain_ms={plain_ms:.6f} "
        f"library_ms={lib_ms:.6f} (F.embedding_bag) bound_ms={b_ms:.6f} ({by}; "
        f"{all_lanes:.6f} counting every lane's row); sums bitwise equal across runs")
    log(f"  gather ceiling on the same ids (device ms): "
        + ", ".join(f"{k} {v:.6f}" for k, v in ceiling.items()))
    log(f"  K5 at serve_p99 ({n_p99} bags, {p99_distinct} distinct rows): kernel_ms={p99_ms:.6f} "
        f"device_ms={p99_dev_ms:.6f} bound_ms={p99_bound:.6f}; host us a call: "
        + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in host.items()))
    return n_k5, k5, dict(steps=times, splits=splits, upload_p99_s=upload,
                          init_s=t_init, batches_s=t_data, oracle_err=oracle_err,
                          unsorted_fallback_count=ops.unsorted_fallback_count)

# ---------------------------------------------------------------------------
# phase 11: the streaming engine
# ---------------------------------------------------------------------------
def launch_counts() -> dict:
    from repro_torch.kernels import compact, peel, segsum

    return {"segment_sum_sorted": segsum.launches, "peel_edges": peel.launches,
            "prefix_sum": compact.prefix_sum_launches,
            "stream_compact": compact.stream_compact_launches,
            "peel_edges_rows": peel.rows_launches, "segment_sum_rows": segsum.rows_launches}


def zero_launch_counts() -> None:
    from repro_torch.kernels import compact, peel, segsum

    segsum.launches = peel.launches = peel.rows_launches = segsum.rows_launches = 0
    compact.prefix_sum_launches = compact.stream_compact_launches = 0


def same_answer(a, b) -> bool:
    """Two engines' QueryResults agree: the density's and warm density's f32
    bits, the masks, passes, the path taken and the certificate's ints."""
    def bits(x):
        return np.float32(x).view(np.int32)

    def cert(c):
        return None if c is None else (c.best_ne, c.best_nv, c.dual_num, c.dual_den)

    return (bits(a.density) == bits(b.density) and bits(a.warm_density) == bits(b.warm_density)
            and a.passes == b.passes and np.array_equal(a.mask, b.mask)
            and np.array_equal(a.warm_mask, b.warm_mask)
            and (a.pruned, a.refreshed, a.refine_rounds, a.certified_skip, cert(a.certificate))
            == (b.pruned, b.refreshed, b.refine_rounds, b.certified_skip, cert(b.certificate)))


def phase_stream(device: str, graph: dict = STREAM_GRAPH, engine: dict = STREAM_ENGINE,
                 n_batches: int = STREAM_BATCHES, events: int = STREAM_EVENTS
                 ) -> tuple[dict, dict, list]:
    """Returns (launches by kernel on the stream's main path, times, the
    kernel-on engine's answers: the seed query's, then each batch's)."""
    import torch

    from repro_torch.core import pbahmani
    from repro_torch.graphs.generators import planted_dense
    from repro_torch.kernels import compact, peel, segsum
    from repro_torch.obs import AUDITOR
    from repro_torch.stream import DeltaEngine

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    g, _, _ = planted_dense(**graph)
    seed_edges = np.stack([g.src[:g.n_edges], g.dst[:g.n_edges]], axis=1)
    t_graph = time.perf_counter() - t0
    on = DeltaEngine(g.n_nodes, kernel=True, device=device, **engine)
    off = DeltaEngine(g.n_nodes, kernel=False, device=device, **engine)
    rng = np.random.default_rng(1)
    times = {"ingest_ms": [], "resort_ms": [], "query_ms": [], "query_off_ms": [],
             "refresh_ms": [], "refresh_off_ms": []}
    per_query, held = [], []   # launches a query; (graph, answer) for the cold peel
    compiles0 = DeltaEngine.compile_count()
    # the host's share: the kernel-on engine's buffer calls, timed in place
    host_ms = {"apply": [], "epoch_compact": [], "dst_sorted_state": []}
    for name in host_ms:
        def timed(*a, _real=getattr(on.buffer, name), _name=name, **k):
            t0 = time.perf_counter()
            out = _real(*a, **k)
            host_ms[_name].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(on.buffer, name, timed)

    def ingest(insert=None, delete=None):
        st, ms = synced_ms(lambda: on.apply_updates(insert=insert, delete=delete))
        st_off = off.apply_updates(insert=insert, delete=delete)
        check({k: v for k, v in vars(st).items() if k not in ("latency_ms", "compiled")}
              == {k: v for k, v in vars(st_off).items() if k not in ("latency_ms", "compiled")},
              f"UpdateStats differ, kernel on {st} and off {st_off}")
        return st, ms

    def query(label):
        """One query on both engines: the kernel-on one re-sorted first (timed
        apart; a refresh re-uploads sorted lanes instead), its launches and
        edge stages counted, the two answers held equal."""
        stale, plans = on.stale, on.metrics.n_plan_builds
        if not on._sorted and not stale:
            _, ms = synced_ms(on._resort)
            times["resort_ms"].append(ms)
        before = launch_counts()
        pass_calls, kcore_calls = edge_stage_calls()
        with pass_calls, kcore_calls:
            q, ms = synced_ms(on.query)
        d = {k: v - before[k] for k, v in launch_counts().items()}
        check(bool(torch.all(on._dst[1:] >= on._dst[:-1])),
              f"{label}: the kernel-on engine's lanes are not dst-sorted after the query")
        q_off, ms_off = synced_ms(off.query)
        check(same_answer(q, q_off), f"{label}: kernel on {q.density!r}/{q.passes} differs "
              f"from kernel off {q_off.density!r}/{q_off.passes}")
        check(q.pruned, f"{label}: the query did not take the pruned path")
        plan_built = on.metrics.n_plan_builds - plans
        check(d["peel_edges"] == pass_calls.n + kcore_calls.n and pass_calls.n == q.passes,
              f"{label}: K2 launched {d['peel_edges']} times for {q.passes} passes "
              f"({pass_calls.n} edge stages) and {kcore_calls.n} plan iterations")
        check((d["segment_sum_sorted"], d["prefix_sum"], d["stream_compact"])
              == (2 + plan_built, 2, 3),
              f"{label}: K1 {d['segment_sum_sorted']}, K3 {d['prefix_sum']}, K4 "
              f"{d['stream_compact']} launches (expected {2 + plan_built}, 2, 3)")
        check(not q.compiled, f"{label}: the query loaded a kernel library")
        (times["refresh_ms" if q.refreshed else "query_ms"]).append(ms)
        (times["refresh_off_ms" if q.refreshed else "query_off_ms"]).append(ms_off)
        per_query.append(dict(label=label, refreshed=q.refreshed, passes=q.passes,
                              plan_built=plan_built, launches=d, ms=ms))
        return q

    # the main path: every count 0 now, read after the engines' last call (the
    # kernel-off engine launches no kernel; the cold peels run after the read)
    zero_launch_counts()
    _, seed_ms = ingest(insert=seed_edges)
    q = query("seed")
    answers = [q]
    steady0 = AUDITOR.audited_steady_recompiles
    for b in range(n_batches):
        u, v = on.buffer.host_view()
        live = np.flatnonzero(u < on.buffer.sentinel)
        take = rng.choice(live, events // 5, replace=False)
        inserts = rng.integers(0, g.n_nodes, (events - events // 5, 2))
        _, ms = ingest(insert=inserts, delete=np.stack([u[take], v[take]], axis=1))
        times["ingest_ms"].append(ms)
        q = query(f"batch {b}")
        answers.append(q)
        if q.refreshed and not held:
            held.append(("after the first refresh", on.buffer.to_graph(), q))
    held.append(("after the last batch", on.buffer.to_graph(), q))
    # a pruned query's device split, profiled once (the plan and the sorted
    # lanes reused: a repeat of the last query on the same graph, on both
    # engines, so that they stay in step)
    def requery(eng):
        eng._cached_query = None
        return eng.query()

    prof = profile_call(lambda: requery(on))
    check(same_answer(requery(on), requery(off)), "a repeated query differs, kernel on/off")
    r1, refine_ms = synced_ms(lambda: on.query(refine=True))
    check(same_answer(r1, off.query(refine=True)), "the refined query differs, kernel on/off")
    u, v = on.buffer.host_view()
    take = rng.choice(np.flatnonzero(u < on.buffer.sentinel), 16, replace=False)
    ingest(delete=np.stack([u[take], v[take]], axis=1))
    r2, refine2_ms = synced_ms(lambda: on.query(refine=True))
    check(same_answer(r2, off.query(refine=True)),
          "the refined query after the delete-only batch differs, kernel on/off")
    c_on, cbds_ms = synced_ms(lambda: on.cbds(rounds=1))
    launches = launch_counts()
    c_off = off.cbds(rounds=1)
    check(all(np.array_equal(c_on[k], c_off[k]) for k in c_on), "cbds differs, kernel on/off")
    check(AUDITOR.audited_steady_recompiles == steady0 and DeltaEngine.compile_count()
          == compiles0, f"{AUDITOR.audited_steady_recompiles - steady0} steady recompiles, "
          f"{DeltaEngine.compile_count() - compiles0} library loads in the stream")

    # held against a cold peel of the materialized graph on the card
    for label, gr, ans in held:
        cold = pbahmani(gr, eps=engine["eps"], kernel=True, device=device)
        check(np.float32(cold[0]).view(np.int32) == np.float32(ans.density).view(np.int32)
              and cold[2] == ans.passes and np.array_equal(cold[1], ans.mask),
              f"{label}: the engine {ans.density!r}/{ans.passes} differs from a cold "
              f"pbahmani {cold[0]!r}/{cold[2]}")
    # the certified skip on the card: a proved certificate answers a
    # delete-only follow-up with no peel (the stream of tests/test_torch_stream.py)
    tiny = DeltaEngine(8, refresh_every=10**9, kernel=True, device=device)
    tiny.apply_updates(insert=np.array([[0, 1], [1, 2], [0, 2], [3, 4], [4, 5], [5, 6]]))
    proved = tiny.query(refine=True, target_gap=0.0, max_refine_rounds=200)
    tiny.apply_updates(delete=np.array([[4, 5]]))
    skip = tiny.query(refine=True, target_gap=0.0)
    check(proved.certificate.proves_optimal and skip.certified_skip and skip.passes == 0
          and skip.density == 1.0, "the certified skip did not happen on the card")

    med = {k: statistics.median(v) for k, v in times.items() if v}
    resort_share = (statistics.median(times["resort_ms"])
                    / statistics.median([a + b for a, b in zip(times["resort_ms"],
                                                               times["query_ms"])]))
    log(f"  planted_dense({graph}) built in {t_graph:.3f} s: |V|={g.n_nodes} "
        f"|E|={g.n_edges}; DeltaEngine({engine}) seeded in {seed_ms / 1e3:.3f} s "
        f"(host EdgeBuffer.apply of {g.n_edges} edges), kernel on and off")
    log(f"  {n_batches} batches of {events} events (80 % uniform inserts, 20 % deletes "
        f"of present edges), a query after each: kernel on == off at every query "
        f"({len(per_query)}), all pruned; {on.metrics.n_refreshes} refreshes; "
        f"|E| {on.n_edges}, capacity {on.buffer.capacity}; lanes dst-sorted after every "
        f"query; the engine == a cold pbahmani {', '.join(h[0] for h in held)}")
    log(f"  launches a query (K1, K2, K3, K4): " + "; ".join(
        f"{p['label']}{' (refresh)' if p['refreshed'] else ''}: "
        f"{p['launches']['segment_sum_sorted']}, {p['launches']['peel_edges']} "
        f"({p['passes']} passes{', plan' if p['plan_built'] else ''}), "
        f"{p['launches']['prefix_sum']}, {p['launches']['stream_compact']}"
        for p in per_query))
    log(f"  ms, median (all): ingest {med['ingest_ms']:.3f} ({times['ingest_ms']}); re-sort "
        f"{med['resort_ms']:.3f} ({times['resort_ms']}), {resort_share:.3f} of a query with "
        f"it; pruned query {med['query_ms']:.3f} ({times['query_ms']}), kernel off "
        f"{med['query_off_ms']:.3f}; refresh {med['refresh_ms']:.3f} ({times['refresh_ms']})"
        f", kernel off {med['refresh_off_ms']:.3f}")
    log(f"  host, median (all) ms: EdgeBuffer.apply {statistics.median(host_ms['apply'][1:]):.3f}"
        f" a batch ({host_ms['apply']}, the seed first); a refresh's epoch_compact "
        f"{host_ms['epoch_compact']} and host dst sort {host_ms['dst_sorted_state']}")
    log(f"  refine: {refine_ms:.3f} ms ({r1.refine_rounds} rounds, rel_gap "
        f"{r1.certificate.rel_gap!r}); after a delete-only batch of 16 {refine2_ms:.3f} ms "
        f"(certified skip: {r2.certified_skip}, {r2.refine_rounds} rounds, its seed query a "
        f"refresh: {r2.refreshed}); cbds(rounds=1) "
        f"{cbds_ms:.3f} ms (k*={c_on['k_star']}, density {c_on['density']!r}); on == off; "
        f"zero audited steady recompiles; a proved certificate skips the peel on the card")
    log(f"  profiled pruned query: " + (
        f"window {prof['window_ms']:.6f} ms, device busy {prof['busy_ms']:.6f} ms (idle "
        f"{prof['idle_share']:.4f}), {prof['device_launches']} device launches; busiest: "
        + "; ".join(f"{k} {t:.6f}" for k, t in prof["top_ms"].items())
        if prof else "no device activity recorded (not measured)"))
    times.update(seed_ms=seed_ms, graph_s=t_graph, first_query=per_query[0],
                 per_query=per_query, refine_ms=refine_ms, refine_rounds=r1.refine_rounds,
                 refine_after_delete_ms=refine2_ms, certified_skip=r2.certified_skip,
                 cbds_ms=cbds_ms, resort_share=resort_share, medians=med, profile=prof,
                 host_ms=host_ms,
                 n_refreshes=on.metrics.n_refreshes)
    return launches, times, answers


# ---------------------------------------------------------------------------
# phase 12: the fused multi-tenant service
# ---------------------------------------------------------------------------
def mixed_batch(rng, eng, n: int, events: int):
    """``benchmarks/bench_tenants.py:_mixed_batch``'s traffic: half uniform
    inserts, half deletes of present edges (drawn from the buffer's live
    slots), so |E| churns at about constant size."""
    u, v = eng.buffer.host_view()
    live = np.flatnonzero(u < eng.buffer.sentinel)
    take = rng.choice(live, min(events // 2, live.size), replace=False)
    return rng.integers(0, n, (events // 2, 2)), np.stack([u[take], v[take]], axis=1)


def kernel_split(fn, calls: int = 20) -> dict:
    """Device time of one ``fn()`` call by kernel name (memsets as
    ``Memset``), in ms: the mean over ``calls`` calls traced by
    torch.profiler. Empty when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.name.startswith("obs:"):
            continue
        name = ev.name.replace("(anonymous namespace)::", "").replace("void ", "")
        name = re.split(r"[<(]", name)[0].split("::")[-1].strip()
        out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / calls / 1e3
    return out


def flushed_ms(fn, iters: int = 20) -> float:
    """Median device time of one ``fn()`` with a cold L2: the call captured
    in a CUDA graph, and before each replay (outside the timed interval) a
    read of 256 MB, five times the H100's 50 MB L2."""
    import torch

    graph = capture_graph(fn)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        flush.sum()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_records(match=lambda fn: True) -> list[dict]:
    """Registers, shared memory and spill bytes of every kernel that ptxas
    reported in this process's builds (``build.build_logs``, nvcc run with
    ``-Xptxas -v``), demangled where ``c++filt`` is there."""
    from repro_torch.kernels import build

    out = []
    for source, text in build.build_logs.items():
        fn, spills = None, (None, None)
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill stores" in line:
                nums = re.findall(r"(\d+) bytes spill", line)
                spills = (int(nums[0]), int(nums[1])) if len(nums) == 2 else (None, None)
            elif "Used" in line and "registers" in line and fn:
                regs = re.search(r"Used (\d+) registers", line)
                smem = re.search(r"(\d+) bytes smem", line)
                out.append(dict(source=source, function=fn, registers=int(regs.group(1)),
                                smem_bytes=int(smem.group(1)) if smem else 0,
                                spill_store_bytes=spills[0], spill_load_bytes=spills[1]))
                fn, spills = None, (None, None)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r["function"] for r in out),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(out):
            for r, name in zip(out, names):
                r["function"] = name
    except (OSError, subprocess.SubprocessError):
        pass
    return [r for r in out if match(r["function"])]


def bucket_lanes(device: str, coo: dict = FUSED_COO):
    """Phase 12's lane bucket as its seed traffic leaves it, built directly:
    [tenants, 2 * capacity] int32 src and dst, row i the symmetric lanes of
    tenant i's seed pairs (``planted_dense(n, clique, ..., seed=i)`` for the
    first ``planted``, else 3n uniform pairs) with a sentinel tail, each row
    sorted by dst; and the degrees [tenants, n]."""
    import torch

    from repro_torch.graphs.generators import planted_dense
    from repro_torch.kernels import ref

    rng = np.random.default_rng(12)
    n, lanes = coo["n"], 2 * coo["capacity"]
    src = np.full((coo["tenants"], lanes), n, np.int32)
    dst = np.full((coo["tenants"], lanes), n, np.int32)
    for i in range(coo["tenants"]):
        if i < coo["planted"]:
            g, _, _ = planted_dense(n, coo["clique"], coo["p_background"], coo["p_planted"],
                                    seed=i)
            pairs = np.stack([g.src[:g.n_edges], g.dst[:g.n_edges]], axis=1)
        else:
            pairs = rng.integers(0, n, (3 * n, 2))
        pairs = pairs[:coo["capacity"]].astype(np.int32)
        k = pairs.shape[0]
        src[i, :k], src[i, k:2 * k] = pairs[:, 0], pairs[:, 1]
        dst[i, :k], dst[i, k:2 * k] = pairs[:, 1], pairs[:, 0]
        order = np.argsort(dst[i], kind="stable")
        src[i], dst[i] = src[i][order], dst[i][order]
    s, d = (torch.from_numpy(x).to(device) for x in (src, dst))
    return s, d, ref.segment_sum_rows_ref(d < n, d, n)


def random_rows(device: str, g: int, lanes: int, v: int, seed: int):
    """[g, lanes] int32 rows at V vertices: about 85 % of each row's lanes
    uniform (dst sorted), the rest the sentinel V."""
    import torch

    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, (g, lanes)).astype(np.int32)
    dst = rng.integers(0, v, (g, lanes)).astype(np.int32)
    live = rng.random((g, lanes)) < 0.85
    src[~live], dst[~live] = v, v
    order = np.argsort(dst, axis=1, kind="stable")
    src, dst = np.take_along_axis(src, order, 1), np.take_along_axis(dst, order, 1)
    return tuple(torch.from_numpy(x).to(device) for x in (src, dst))


def rows_point(src, dst, active, failed, v: int, device: str, full: bool = False) -> dict:
    """K2's and K1's rows entries at one [G, L] shape with V vertices a row:
    checked against their plain versions (K2 with and without the live mask
    and the charges), then timed on the card (``device_ms``: CUDA-graph
    replay; ``flushed_ms``: the same with a cold L2), split by kernel and
    memset (torch.profiler), beside the diagnostic twin: the one-row kernel
    over the same lanes flattened, keys r*(V+1)+id (row r's vertex v at
    r*(V+1)+v, the sentinel columns inactive), which must give the same
    sums. ``full`` adds the wrapper's ``ms``, ``plain_ms``, ``library_ms``
    and ``host_us``."""
    import torch

    from repro_torch.kernels import peel, ref, segsum

    g, L = src.shape
    e = g * L
    err = 0
    for act in (active, None):
        for charge in (False, True):
            got = peel.peel_edges_rows(src, dst, act, failed, n_nodes=v, charge=charge)
            want = ref.peel_edges_rows_ref(src, dst, act, failed, v, charge)
            err = max([err] + [int((x.long() - w.long()).abs().max()) if x.numel() else 0
                               for x, w in zip(got, want)])
    check(err == 0, f"K2 rows [{g}, {L}] V={v} differs from peel_edges_rows_ref by {err}")
    live = dst < v
    k1 = segsum.segment_sum_rows_sorted(live, dst, num_segments=v)
    err1 = int((k1.long() - ref.segment_sum_rows_ref(live, dst, v).long()).abs().max())
    check(err1 == 0, f"K1 rows [{g}, {L}] V={v} differs from segment_sum_rows_ref by {err1}")
    # the twins: keys r*(V+1)+id, one row of G*(V+1) vertices
    base = torch.arange(g, dtype=torch.int32, device=device)[:, None] * (v + 1)
    f_src, f_dst = (base + src).reshape(-1), (base + dst).reshape(-1)
    pad = torch.zeros((g, 1), dtype=torch.bool, device=device)
    f_act = torch.cat([active, pad], 1).reshape(-1)
    f_fail = torch.cat([failed, pad], 1).reshape(-1)
    f_live = live.reshape(-1)
    nf = g * (v + 1)
    rows2 = peel.peel_edges_rows(src, dst, active, failed, n_nodes=v)
    twin2 = peel.peel_edges_sorted(f_src, f_dst, f_act, f_fail, n_nodes=nf)
    check(torch.equal(twin2[0].view(g, v + 1)[:, :v], rows2[0])
          and int(twin2[1]) == int(rows2[1].sum()),
          "the one-row K2 over the flattened rows differs from K2 rows")
    twin1 = segsum.segment_sum_sorted(f_live, f_dst, num_segments=nf, out_dtype=torch.int32)
    check(torch.equal(twin1.view(g, v + 1)[:, :v], k1),
          "the one-row K1 over the flattened rows differs from K1 rows")

    def k2_rows():
        return peel.peel_edges_rows(src, dst, active, failed, n_nodes=v)

    def k1_rows():
        return segsum.segment_sum_rows_sorted(live, dst, num_segments=v)

    def k2_twin():
        return peel.peel_edges_sorted(f_src, f_dst, f_act, f_fail, n_nodes=nf)

    def k1_twin():
        return segsum.segment_sum_sorted(f_live, f_dst, num_segments=nf, out_dtype=torch.int32)

    out = {}
    # K2: src and dst read once, active and failed once, delta and removed
    # written once; K1: ids and bool values read once, the sums written once
    for name, fn, twin, n_bytes, n_ops, e_err in (
            ("k2", k2_rows, k2_twin, e * 8 + g * v * 6 + g * 4, 8 * e, err),
            ("k1", k1_rows, k1_twin, e * 5 + g * v * 4, e, err1)):
        b, by = bound_ms(n_bytes, n_ops)
        r = dict(shape=f"[{g}, {L}] lanes, V={v}", device_ms=graph_ms(fn),
                 flushed_ms=flushed_ms(fn), split_ms=kernel_split(fn),
                 twin_device_ms=graph_ms(twin), twin_flushed_ms=flushed_ms(twin),
                 twin_split_ms=kernel_split(twin), bound_ms=b, bound_by=by,
                 max_abs_err=float(e_err))
        r["bound_share_flushed"] = b / r["flushed_ms"]
        out[name] = r
    if full:
        keys = (base + dst.clamp(max=v)).reshape(-1)
        acc = torch.zeros(nf, dtype=torch.int32, device=device)
        src_flat = (base // (v + 1) * v + src.clamp(max=v - 1)).reshape(-1)
        out["k2"].update(
            ms=time_ms(k2_rows), host_us=host_us(k2_rows),
            plain_ms=time_ms(lambda: ref.peel_edges_rows_ref(src, dst, active, failed, v)),
            library_ms=time_ms(lambda: acc.index_add_(
                0, keys, failed.reshape(-1)[src_flat].to(torch.int32))))
        out["k1"].update(
            ms=time_ms(k1_rows), host_us=host_us(k1_rows),
            plain_ms=time_ms(lambda: ref.segment_sum_rows_ref(live, dst, v)),
            library_ms=time_ms(lambda: acc.index_add_(0, keys, f_live.to(torch.int32))))
    return out


def log_rows_point(label: str, p: dict) -> None:
    for name, title in (("k2", "K2 rows"), ("k1", "K1 rows")):
        r = p[name]
        extra = (f" ms={r['ms']:.6f} host_us={r['host_us']:.3f} plain_ms={r['plain_ms']:.6f} "
                 f"library_ms={r['library_ms']:.6f}" if "ms" in r else "")
        log(f"  {title} {label} {r['shape']}: device_ms={r['device_ms']:.6f} flushed_ms="
            f"{r['flushed_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}; "
            f"{r['bound_share_flushed']:.3f} of the flushed time){extra}; split "
            f"{ {k: round(t, 6) for k, t in r['split_ms'].items()} }; one-row twin "
            f"device_ms={r['twin_device_ms']:.6f} flushed_ms={r['twin_flushed_ms']:.6f} split "
            f"{ {k: round(t, 6) for k, t in r['twin_split_ms'].items()} }")


def rows_kernel_timing(src, dst, deg, v: int, device: str) -> tuple[dict, dict]:
    """K2's and K1's rows entries at a lane bucket's shape (``src``/``dst``
    [G, L], V vertices a row, live masks from the degrees ``deg``): every
    number of ``rows_point`` at all G rows and at the first 4 and 16, a V
    sweep (131,072 vertices a row, and the least V whose packed row state
    passes the shared-memory budget, ``peel.ROWS_SHARED_STATE_BYTES``), and
    the registers and spills ptxas gave every rows kernel. Returns the K2
    and K1 numbers at all G rows, each with the rest under ``by_rows``,
    ``by_v`` and ``ptxas``."""
    import torch

    from repro_torch.kernels import peel, segsum

    g = src.shape[0]
    rng = np.random.default_rng(3)
    active = deg > 0
    failed = active & torch.from_numpy(rng.random((g, v)) < 0.3).to(device)
    check(torch.equal(segsum.segment_sum_rows_sorted(dst < v, dst, num_segments=v), deg),
          "K1 rows over the bucket's lanes differs from the degrees")
    points = {}
    for gs in sorted({4, 16, g} & set(range(1, g + 1)), reverse=True):
        points[gs] = rows_point(src[:gs].contiguous(), dst[:gs].contiguous(), active[:gs],
                                failed[:gs], v, device, full=gs == g)
        log_rows_point(f"G={gs}", points[gs])
    budget = getattr(peel, "ROWS_SHARED_STATE_BYTES", 64 * 1024)
    by_v = {}
    for vs in (131072, 4 * budget + 16):
        s2, d2 = random_rows(device, 8, 1 << 19, vs, seed=vs)
        mask_rng = np.random.default_rng(vs)
        a2 = torch.from_numpy(mask_rng.random((s2.shape[0], vs)) < 0.9).to(device)
        f2 = a2 & torch.from_numpy(mask_rng.random((s2.shape[0], vs)) < 0.3).to(device)
        by_v[vs] = rows_point(s2, d2, a2, f2, vs, device)
        log_rows_point(f"V={vs}", by_v[vs])
        del s2, d2
    # the row-local rows kernels, or the grid-stride ones keyed by RowKeys
    # that they replaced
    regs = ptxas_records(lambda fn: "rows_kernel" in fn or "RowKeys" in fn)
    for r in regs:
        log(f"  ptxas {r['source']} {r['function'][:110]}: {r['registers']} registers, "
            f"{r['smem_bytes']} bytes smem, spill {r['spill_store_bytes']} / "
            f"{r['spill_load_bytes']} bytes")
    out = []
    for name in ("k2", "k1"):
        top = dict(points[g][name])
        top["by_rows"] = {gs: p[name] for gs, p in points.items() if gs != g}
        top["by_v"] = {vs: p[name] for vs, p in by_v.items()}
        top["ptxas"] = [r for r in regs if ("peel" in r["source"]) == (name == "k2")]
        out.append(top)
    return out[0], out[1]


def phase_fused(device: str, coo: dict = FUSED_COO, dense: dict = FUSED_DENSE,
                rounds: int = FUSED_ROUNDS) -> tuple[dict, dict, dict, dict, object]:
    """Returns (launches by kernel on the fused service's main path, times,
    K2 rows numbers, K1 rows numbers, ``flush_round``: one more round of
    traffic on the kernel-on service)."""
    import importlib

    import torch

    from repro_torch.core import pbahmani
    from repro_torch.graphs.generators import planted_dense
    from repro_torch.obs import AUDITOR
    from repro_torch.stream import DeltaEngine, StreamService, query_group

    sf = importlib.import_module("repro_torch.stream.fused")
    svc_mod = importlib.import_module("repro_torch.stream.service")
    batched = importlib.import_module("repro_torch.core.batched")
    loads = importlib.import_module("repro_torch.refine.loads")
    prune = importlib.import_module("repro_torch.core.prune")
    kcore = importlib.import_module("repro_torch.core.kcore")
    eps, refresh_every = 0.1, 4

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    coo_names = [f"coo{i:02d}" for i in range(coo["tenants"])]
    dense_names = [f"dense{i:02d}" for i in range(dense["tenants"])]
    pruned_of = {name: i < coo["planted"] for i, name in enumerate(coo_names)}
    pruned_of.update({name: False for name in dense_names})
    seeds = {}
    for i, name in enumerate(coo_names):
        if pruned_of[name]:
            g, _, _ = planted_dense(coo["n"], coo["clique"], coo["p_background"],
                                    coo["p_planted"], seed=i)
            seeds[name] = (np.stack([g.src[:g.n_edges], g.dst[:g.n_edges]], axis=1), None)
        else:  # bench_tenants.py's seed rule: 3n uniform pairs
            seeds[name] = (rng.integers(0, coo["n"], (3 * coo["n"], 2)), None)
    for name in dense_names:
        seeds[name] = (rng.integers(0, dense["n"], (dense["seed_pairs"], 2)), None)
    t_data = time.perf_counter() - t0

    def config(name):
        return dict(n_nodes=(coo if name.startswith("coo") else dense)["n"],
                    capacity=(coo if name.startswith("coo") else dense)["capacity"],
                    pruned=pruned_of[name])

    services = {k: StreamService(max_tenants=len(coo_names) + len(dense_names), fused=True,
                                 eps=eps, refresh_every=refresh_every,
                                 coalesce_window_ms=1e9, kernel=k, device=device)
                for k in (True, False)}
    for svc in services.values():
        for name in coo_names + dense_names:
            r = svc.create_tenant(name, **config(name))
            check(r.ok and r.value["placement"] == "fused", f"create_tenant {name}: {r}")
    on, off = services[True], services[False]
    # the comparisons: solo engines of every lane-bucket tenant (the
    # sequential baseline too) and of four dense ones, fed the same stream
    solo = {name: DeltaEngine(eps=eps, refresh_every=refresh_every, kernel=True, device=device,
                              **config(name)) for name in coo_names + dense_names[:4]}
    # main-path launches: deltas around the kernel-on service's own calls
    zero_launch_counts()
    main_launches = {k: 0 for k in launch_counts()}

    def on_main(fn):
        before = launch_counts()
        out, ms = synced_ms(fn)
        for k, n in launch_counts().items():
            main_launches[k] += n - before[k]
        return out, ms

    # every flush's accounting, recorded around fused._flush
    flush_log: list[dict] = []
    failures: list = []
    real_flush, real_qg = sf._flush, svc_mod.query_group

    def counted_flush(batch, members, **kw):
        if not batch.kernel:
            return real_flush(batch, members, **kw)
        lane_passes = (CallCount(batched, "peel_edges_rows"),
                       CallCount(loads, "peel_edges_rows"))
        single_pass, kcore_iters = edge_stage_calls()
        k1_rows = CallCount(prune, "lane_degrees_rows")
        plans = CallCount(DeltaEngine, "_rebuild_plan")
        preps = CallLog(sf, "prepare_pruned_peel_rows")
        buckets = CallLog(sf, "_batched_bucket_peel")
        before = launch_counts()
        with lane_passes[0], lane_passes[1], single_pass, kcore_iters, k1_rows, plans, \
                preps, buckets:
            out, ms = synced_ms(lambda: real_flush(batch, members, **kw))
        d = {k: n - before[k] for k, n in launch_counts().items()}
        fit = sum(isinstance(x, prune.PrunedDispatch) for _, _, res in preps.calls for x in res)
        rows = sum(a[0].shape[0] for a, _, _ in buckets.calls)
        rec = dict(bucket=f"{batch.node_capacity}x{batch.edge_capacity}",
                   members=len(members), ms=ms, launches=d,
                   lane_passes=lane_passes[0].n + lane_passes[1].n, plans=plans.n,
                   kcore_iterations=kcore_iters.n, preps_fit=fit, bucket_peels=buckets.n,
                   bucket_rows=rows, refine=bool(kw.get("refine")))
        flush_log.append(rec)
        check(single_pass.n == 0, f"a flush ran {single_pass.n} single-tenant passes")
        check(d["peel_edges_rows"] == rec["lane_passes"],
              f"flush {rec}: K2 rows launched {d['peel_edges_rows']} times for "
              f"{rec['lane_passes']} batched passes")
        check(d["peel_edges"] == kcore_iters.n,
              f"flush {rec}: {d['peel_edges']} single-row K2 launches beside "
              f"{kcore_iters.n} plan iterations (no tenant's pass may be single)")
        check(d["segment_sum_rows"] == k1_rows.n == (1 if preps.n else 0) + buckets.n,
              f"flush {rec}: K1 rows {d['segment_sum_rows']} for {preps.n} preps and "
              f"{buckets.n} bucket peels")
        check(d["segment_sum_sorted"] == plans.n,
              f"flush {rec}: K1 {d['segment_sum_sorted']} for {plans.n} plans")
        check((d["prefix_sum"], d["stream_compact"]) == (fit + rows, fit + 2 * rows),
              f"flush {rec}: K3 {d['prefix_sum']}, K4 {d['stream_compact']} (expected "
              f"{fit + rows}, {fit + 2 * rows})")
        return out

    def watched_qg(*a, **k):
        try:
            return real_qg(*a, **k)
        except Exception as exc:  # the service would hide it behind its fallback
            failures.append(repr(exc))
            raise

    sf._flush, svc_mod.query_group = counted_flush, watched_qg
    times = {"seed_ingest_ms": None, "ingest_ms": [], "flush_ms": [], "top_k_ms": []}
    per_round = []
    try:
        # seeding: one ingest_many a service
        r_on, times["seed_ingest_ms"] = on_main(lambda: on.ingest_many(seeds))
        r_off = off.ingest_many(seeds)
        check(r_on.ok and r_off.ok, f"seeding failed: {r_on.error} / {r_off.error}")
        for name, (ins, _) in seeds.items():
            if name in solo:
                solo[name].apply_updates(insert=ins)
        compiles0 = steady0 = None
        for rnd in range(rounds):
            if rnd == 1:  # every library is loaded by the end of the first round
                compiles0, steady0 = (DeltaEngine.compile_count(),
                                      AUDITOR.audited_steady_recompiles)
            upd = {}
            for name in coo_names + dense_names:
                c = coo if name.startswith("coo") else dense
                upd[name] = mixed_batch(rng, on.registry.get(name), c["n"], c["events"])
            r_on, ms = on_main(lambda: on.ingest_many(upd))
            r_off = off.ingest_many(upd)
            check(r_on.ok and r_off.ok and r_on.error is None,
                  f"round {rnd}: ingest_many failed: {r_on.error} / {r_off.error}")
            times["ingest_ms"].append(ms)
            for name in solo:
                solo[name].apply_updates(insert=upd[name][0], delete=upd[name][1])
            n_flush = len(flush_log)
            tickets = [(on.submit_density(t), off.submit_density(t), t)
                       for t in coo_names + dense_names]
            flushed, ms = on_main(on.flush)
            check(flushed == len(tickets) and off.flush() == len(tickets),
                  f"round {rnd}: the flushes answered {flushed} of {len(tickets)}")
            times["flush_ms"].append(ms)
            refreshed = 0
            for a, b, t in tickets:
                ra, rb = on.poll(a), off.poll(b)
                check(ra is not None and rb is not None and ra.ok and rb.ok
                      and ra.error is None and rb.error is None,
                      f"round {rnd} {t}: an error response: {ra} / {rb}")
                qa, qb = on.registry.get(t)._cached_query, off.registry.get(t)._cached_query
                check(same_answer(qa, qb), f"round {rnd} {t}: kernel on {qa.density!r}/"
                      f"{qa.passes} differs from off {qb.density!r}/{qb.passes}")
                check(ra.value == rb.value, f"round {rnd} {t}: responses differ")
                refreshed += qa.refreshed
                if t in solo:
                    qs = solo[t].query()
                    check(same_answer(qa, qs), f"round {rnd} {t}: fused {qa.density!r}/"
                          f"{qa.passes} differs from the solo engine {qs.density!r}/"
                          f"{qs.passes}")
            for batch in on.registry.fused_pool.batches.values():
                for lane in batch.lane_of.values():
                    check(batch._unsorted[lane] or bool(torch.all(
                        batch._dst[lane][1:] >= batch._dst[lane][:-1])),
                          f"round {rnd}: row {lane} of {batch} is not dst-sorted")
                    check(not batch._unsorted[lane] or not batch.kernel,
                          f"round {rnd}: row {lane} left unsorted after its query")
            top, ms = on_main(lambda: on.top_k_densest(10))
            top_off = off.top_k_densest(10)
            check(top.ok and top.value == top_off.value, f"round {rnd}: top_k differs")
            times["top_k_ms"].append(ms)
            per_round.append(dict(round=rnd, refreshed=refreshed,
                                  flushes=flush_log[n_flush:], top=top.value[:3]))
        # refinement per bucket, fixed rounds (bit-identical to solo loops)
        refined = {}
        for label, names in (("coo", coo_names), ("dense", dense_names)):
            engines = {t: on.registry.get(t) for t in names}
            refined[label], ms = on_main(lambda: query_group(
                engines, refine=True, target_gap=-1.0, max_refine_rounds=8))
            times[f"refine_{label}_ms"] = ms
            ref_off = query_group({t: off.registry.get(t) for t in names}, refine=True,
                                  target_gap=-1.0, max_refine_rounds=8)
            for t in names:
                check(same_answer(refined[label][t], ref_off[t]),
                      f"refine {t}: kernel on differs from off")
            for t in [x for x in names if x in solo][:4]:
                qs = solo[t].query(refine=True, target_gap=-1.0, max_refine_rounds=8)
                check(same_answer(refined[label][t], qs), f"refine {t}: fused differs "
                      f"from the solo engine")
        launches = dict(main_launches)
    finally:
        sf._flush, svc_mod.query_group = real_flush, real_qg
    check(not failures, f"a fused flush raised: {failures}")
    check(DeltaEngine.compile_count() == compiles0
          and AUDITOR.audited_steady_recompiles == steady0,
          f"{DeltaEngine.compile_count() - compiles0} library loads or graph captures and "
          f"{AUDITOR.audited_steady_recompiles - steady0} steady recompiles after round 1")
    kernel_flushes = [f for f in flush_log if f["lane_passes"]]
    check(kernel_flushes and all(f["launches"]["peel_edges_rows"] == f["lane_passes"]
                                 for f in flush_log),
          "no flush ran K2 rows once a batched pass")
    check(any(f["bucket_peels"] for f in flush_log) and launches["segment_sum_rows"] > 0,
          "no flush ran the batched bucket peel (K1 rows)")

    # every tenant == a cold pbahmani of its materialized graph
    t_cold = time.perf_counter()
    for t in coo_names + dense_names:
        eng = on.registry.get(t)
        q = eng.query()
        d, m, p = pbahmani(eng.buffer.to_graph(), eps=eps, kernel=True, device=device)
        check(np.float32(d).view(np.int32) == np.float32(q.density).view(np.int32)
              and p == q.passes and np.array_equal(m, q.mask),
              f"{t}: fused {q.density!r}/{q.passes} differs from a cold pbahmani {d!r}/{p}")
    t_cold = time.perf_counter() - t_cold

    # sequential dispatch (solo engines, one query a tenant) against one
    # query_group of the same 32 lane-bucket tenants, memoization defeated
    fused_coo = {t: on.registry.get(t) for t in coo_names}

    def requery_fused():
        for eng in fused_coo.values():
            eng._cached_query = None
        return query_group(fused_coo)

    def requery_solo():
        out = {}
        for t in coo_names:
            solo[t]._cached_query = None
            out[t] = solo[t].query()
        return out

    seq_s, fused_s = [], []
    for _ in range(3):
        a, ms_seq = synced_ms(requery_solo)
        b, ms_fused = synced_ms(requery_fused)
        seq_s.append(ms_seq / 1e3)
        fused_s.append(ms_fused / 1e3)
        check(all(same_answer(a[t], b[t]) for t in coo_names),
              "a requery differs between the fused and the solo engines")
    prof = profile_call(requery_fused)
    prof_seq = profile_call(requery_solo)
    batch = next(iter(fused_coo.values())).batch
    lanes = sorted(batch.lane_of.values())
    batch.resort(lanes)
    b_src, b_dst, b_deg, _ = batch.rows(lanes)
    k2_rows, k1_rows = rows_kernel_timing(b_src, b_dst, b_deg, batch.node_capacity, device)

    med = {k: statistics.median(v) for k, v in times.items() if isinstance(v, list) and v}
    qps_seq = len(coo_names) / statistics.median(seq_s)
    qps_fused = len(coo_names) / statistics.median(fused_s)
    kf = [f for f in flush_log if f["bucket"].startswith(str(coo["n"]))]
    log(f"  data built in {t_data:.3f} s; {len(coo_names)} lane-bucket tenants "
        f"({coo['planted']} planted_dense({coo['n']}, {coo['clique']}, ...) pruned, the rest "
        f"3n uniform pairs), {len(dense_names)} dense tenants at {dense['n']} vertices; "
        f"seeding ingest_many {times['seed_ingest_ms']:.3f} ms (kernel-on service)")
    log(f"  {rounds} rounds of ingest_many ({coo['events']} / {dense['events']} events a "
        f"tenant, half inserts, half deletes), a coalesced flush of {len(tickets)} "
        f"submit_density and top_k_densest(10) each: kernel on == off == solo at every "
        f"answer; refreshed a round: {[r['refreshed'] for r in per_round]}")
    for f in flush_log:
        log(f"  flush {f['bucket']}{' refine' if f['refine'] else ''}: {f['members']} members, "
            f"{f['ms']:.3f} ms, {f['lane_passes']} batched lane passes, launches "
            f"{ {k: v for k, v in f['launches'].items() if v} }, plans {f['plans']}, preps fit "
            f"{f['preps_fit']}, bucket peels {f['bucket_peels']} ({f['bucket_rows']} rows)")
    log(f"  ms, median (all): ingest_many {med['ingest_ms']:.3f} ({times['ingest_ms']}); "
        f"coalesced flush {med['flush_ms']:.3f} ({times['flush_ms']}); top_k "
        f"{med['top_k_ms']:.3f}; refine (8 rounds) lane bucket "
        f"{times['refine_coo_ms']:.3f}, dense bucket {times['refine_dense_ms']:.3f}")
    log(f"  every tenant == a cold pbahmani ({t_cold:.3f} s); zero library loads, graph "
        f"captures and steady recompiles after round 1; no error response")
    log(f"  sequential ({len(coo_names)} solo DeltaEngines) {seq_s} s vs fused (one query_group) "
        f"{fused_s} s: {qps_seq:.1f} vs {qps_fused:.1f} queries/s "
        f"({qps_fused / qps_seq:.2f}x)")
    for label, pr in (("fused requery", prof), ("sequential requery", prof_seq)):
        log(f"  profiled {label}: " + (
            f"window {pr['window_ms']:.6f} ms, device busy {pr['busy_ms']:.6f} ms (idle "
            f"{pr['idle_share']:.4f}), {pr['device_launches']} device launches; busiest: "
            + "; ".join(f"{k} {t:.6f}" for k, t in pr["top_ms"].items())
            if pr else "no device activity recorded (not measured)"))
    times.update(flushes=flush_log, per_round=per_round, medians=med, cold_check_s=t_cold,
                 sequential_s=seq_s, fused_s=fused_s, qps_sequential=qps_seq,
                 qps_fused=qps_fused, profile_fused=prof, profile_sequential=prof_seq,
                 lane_bucket_flush_ms=[f["ms"] for f in kf], data_s=t_data)

    def flush_round(measure):
        """One more round of this phase's traffic on the kernel-on service
        (phase 14 counts the host syncs of its flush): ``ingest_many``, every
        tenant's ``submit_density``, then ``measure(on.flush)``."""
        upd = {name: mixed_batch(rng, on.registry.get(name),
                                 (coo if name.startswith("coo") else dense)["n"],
                                 (coo if name.startswith("coo") else dense)["events"])
               for name in coo_names + dense_names}
        check(on.ingest_many(upd).ok, "phase 14: the extra round's ingest_many failed")
        for name in coo_names + dense_names:
            on.submit_density(name)
        return measure(on.flush)

    return launches, times, k2_rows, k1_rows, flush_round


# ---------------------------------------------------------------------------
# phase 13: the sharded tier (core/distributed.py) on torch.distributed
# ---------------------------------------------------------------------------
SHARD_STREAM_BATCHES = 4          # phase 11's first 4 batches
SHARD_FUSED = dict(FUSED_COO, tenants=8, planted=4)   # phase 12's lane bucket, cut
SHARD_FUSED_ROUNDS = 2
SHARD_REFINE = dict(refine=True, target_gap=-1.0, max_refine_rounds=4)
SPAWN_TIMEOUT_S = 480             # world 2, both ranks together; killed past it


def stream_batches(rng, eng, n: int, events: int):
    """Phase 11's churn batch drawn against ``eng``'s buffer: 80 % uniform
    inserts, 20 % deletes of present edges."""
    u, v = eng.buffer.host_view()
    take = rng.choice(np.flatnonzero(u < eng.buffer.sentinel), events // 5, replace=False)
    return rng.integers(0, n, (events - events // 5, 2)), np.stack([u[take], v[take]], axis=1)


def same_triple(a, b) -> bool:
    return (np.float32(a[0]).view(np.int32) == np.float32(b[0]).view(np.int32)
            and a[2] == b[2] and np.array_equal(a[1], b[1]))


def sharded_pass_split(prof: dict) -> dict:
    """A profiled sharded call's device time by role: K2, the all-reduce (an
    NCCL kernel, or gloo's copies through pinned host memory; the pass
    loop's own reads of its counts go to pageable memory), the rest of the
    device, and the host (the window's idle time). ``prof`` is
    ``profile_call(fn, top=None)``'s."""
    if not prof:
        return {}
    by_name = prof["top_ms"]
    k2 = sum(t for k, t in by_name.items() if "peel_kernel" in k)
    coll = sum(t for k, t in by_name.items() if "nccl" in k.lower() or "Pinned" in k)
    return dict(k2_ms=k2, all_reduce_ms=coll, other_device_ms=prof["busy_ms"] - k2 - coll,
                host_ms=prof["window_ms"] - prof["busy_ms"], busy_ms=prof["busy_ms"],
                window_ms=prof["window_ms"], device_launches=prof["device_launches"],
                by_name_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))


def _world2_rank(rank: int, world: int, init: str, data: str, out: str,
                 device: str = "cuda") -> None:
    """One rank of phase 13's world 2: a gloo group, every rank on cuda:0
    (NCCL refuses two ranks on one device); ``pbahmani_distributed`` at eps
    0.1 on phase 4's graph and the sharded stream's seed and 2 batches.
    Writes its answers and, on the card, its times to ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collective, distributed
    from repro_torch.graphs.convert import graph_from_arrays
    from repro_torch.kernels import peel, segsum
    from repro_torch.stream import DeltaEngine

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        segsum.load_library()
        peel.load_library()  # built by the parent's phase 1: a load, not a build
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        arrays = np.load(data)
        g = graph_from_arrays(int(arrays["n_nodes"]), int(arrays["n_edges"]), arrays["src"],
                              arrays["dst"], int(arrays["n_directed"]))
        mesh = distributed.make_mesh(device="cuda:0" if on_card else device)
        res = {}
        k2, coll = peel.launches, collective.collectives
        d, mask, passes = distributed.pbahmani_distributed(g, mesh, eps=0.1, kernel=on_card)
        res.update(pb=np.array([np.float32(d).view(np.int32), passes]), pb_mask=mask,
                   pb_counts=np.array([peel.launches - k2 if on_card else passes,
                                       collective.collectives - coll]))
        res["pb_wall_s"] = np.array(wall_s(
            lambda: distributed.pbahmani_distributed(g, mesh, eps=0.1), 3) if on_card else [])
        # every rank makes the same calls, or the group's collectives part
        split = sharded_pass_split(profile_call(
            lambda: distributed.pbahmani_distributed(g, mesh, eps=0.1), top=None)
            if on_card else {})
        res["pb_split"] = np.array(json.dumps(split, default=str))
        n = int(arrays["stream_n"])
        eng = DeltaEngine(n, sharded=True, mesh=mesh, **json.loads(str(arrays["engine"])))
        rng = np.random.default_rng(1)
        eng.apply_updates(insert=arrays["seed_edges"])
        for i in range(3):
            if i:
                eng.apply_updates(*stream_batches(rng, eng, n, int(arrays["events"])))
            q = eng.query()
            res[f"stream{i}"] = np.array([np.float32(q.density).view(np.int32), q.passes,
                                          q.refreshed, q.pruned])
            res[f"stream{i}_mask"] = q.mask
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def phase_world2(g, device: str, stream_seed, stream_n: int, engine: dict, events: int,
                 world1: dict) -> dict:
    """Spawns phase 13's world 2 (``_world2_rank``) and holds both ranks'
    answers to world 1's. A rank that fails, or a spawn past
    ``SPAWN_TIMEOUT_S``, fails the smoke."""
    import multiprocessing
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="smoke_world2_"))
    data = tmp / "graph.npz"
    np.savez(data, src=g.src, dst=g.dst, n_nodes=g.n_nodes, n_edges=g.n_edges,
             n_directed=g.n_directed, seed_edges=stream_seed, stream_n=stream_n,
             engine=json.dumps(engine), events=events)
    ctx = multiprocessing.get_context("spawn")  # CUDA is initialized here
    init = f"file://{tmp / 'rendezvous'}"
    outs = [tmp / f"rank{r}.npz" for r in range(2)]
    procs = [ctx.Process(target=_world2_rank,
                         args=(r, 2, init, str(data), str(outs[r]), device))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    check(not hung, f"world 2: {len(hung)} rank(s) still running after {SPAWN_TIMEOUT_S} s")
    check(all(p.exitcode == 0 for p in procs),
          f"world 2: rank exit codes {[p.exitcode for p in procs]}")
    spawn_s = time.perf_counter() - t0
    ranks = [dict(np.load(o)) for o in outs]
    want = world1["pb"]
    for r, res in enumerate(ranks):
        check(int(res["pb"][0]) == int(np.float32(want[0]).view(np.int32))
              and int(res["pb"][1]) == want[2] and np.array_equal(res["pb_mask"], want[1]),
              f"world 2 rank {r}: pbahmani_distributed differs from world 1")
        check(tuple(res["pb_counts"]) == (want[2], want[2] + 1),
              f"world 2 rank {r}: K2 launches and collectives {tuple(res['pb_counts'])} "
              f"for {want[2]} passes")
        for i, q in enumerate(world1["stream"][:3]):
            check(np.array_equal(res[f"stream{i}"], [np.float32(q.density).view(np.int32),
                                                     q.passes, q.refreshed, q.pruned])
                  and np.array_equal(res[f"stream{i}_mask"], q.mask),
                  f"world 2 rank {r}: stream query {i} differs from world 1")
    split = json.loads(str(ranks[0]["pb_split"]))
    walls = [list(map(float, res["pb_wall_s"])) or [float("nan")] for res in ranks]
    log(f"  world 2 (gloo, both ranks on {device}:0, spawned; {spawn_s:.3f} s with each rank's "
        f"build of its engine): pbahmani_distributed eps=0.1 and the sharded stream's seed "
        f"and 2 batches == world 1 on both ranks; gloo all-reduces the {device} tensors; wall "
        f"median of 3 by rank {[statistics.median(w) for w in walls]} s ({walls}); "
        f"profiled (rank 0): {split}. Two ranks share one card: not a scaling number")
    return dict(spawn_s=spawn_s, pbahmani_wall_s=walls, pbahmani_split=split)


# ---------------------------------------------------------------------------
# phase 13, world 2 over ("data", "model"): sub-axis meshes, the MoE layers
# at published widths over a mesh, vp_segment_sum with K1 on each rank
# ---------------------------------------------------------------------------
MESH_AXES = ("data", "model")
MESH_MOE = (("grok-1-314b", "tp"), ("deepseek-v3-671b", "ep"))   # (arch, moe_tp / moe_ep)
MESH_TOKENS = 2048          # 1 x 2,048 tokens a MoE layer
MESH_SEED = 27
MESH_VP_D = 16              # [E, 16] float32 messages
# ogbn-products' 2,449,029 nodes (phase 16's GNN_PRODUCTS) and one pad row,
# so that two node blocks split the rows: the sentinel lanes (id 2,449,029,
# zero messages) land there
MESH_VP_ROWS = 2_449_029 + 1
MESH_VP_TOL = (1e-5, 1e-5)  # the gathered blocks against world 1's segment_sum
MESH_AUX_RTOL = 1e-5  # a world-2 rank's aux against world 1's, the same tokens routed
MESH_TIMED = 3


def mesh_moe_layer(cfg, kind: str, device, mesh=None) -> dict:
    """One MoE layer at ``cfg``'s widths in its compute dtype, seeded expert by
    expert, so that a rank draws only its own shard and the shards equal the
    whole layer's: every expert's ``d_ff / |model|`` slice for ``kind="tp"``
    (``moe_tp``), its ``E / |model|`` experts for ``"ep"`` (``moe_ep``); the
    whole layer without a mesh. The router and shared experts are whole."""
    import torch

    n, i = (1, 0) if mesh is None else (mesh.axis_size("model"), mesh.axis_index("model"))
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.compute_dtype

    def draw(seed, shape, scale, out=None):
        g = torch.Generator(device=device).manual_seed(MESH_SEED * 1000 + seed)
        out = torch.empty(shape, dtype=dt, device=device) if out is None else out
        return out.normal_(generator=g).mul_(scale)

    experts = range(i * e // n, (i + 1) * e // n) if kind == "ep" else range(e)
    fl = f // n if kind == "tp" else f
    p = {"router": draw(0, (d, e), d ** -0.5)}
    for k, (shape, scale, cut) in {"wg": ((d, f), d ** -0.5, 1), "wi": ((d, f), d ** -0.5, 1),
                                   "wo": ((f, d), f ** -0.5, 0)}.items():
        local = (d, fl) if cut else (fl, d)
        p[k] = torch.empty((len(experts),) + local, dtype=dt, device=device)
        for j, ex in enumerate(experts):
            seed = 1 + 3 * ex + ("wg", "wi", "wo").index(k)
            if local == shape:
                draw(seed, shape, scale, out=p[k][j])
            else:
                p[k][j].copy_(draw(seed, shape, scale).narrow(cut, i * fl, fl))
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared_wg"] = draw(3 * e + 1, (d, fs), d ** -0.5)
        p["shared_wi"] = draw(3 * e + 2, (d, fs), d ** -0.5)
        p["shared_wo"] = draw(3 * e + 3, (fs, d), fs ** -0.5)
    return p


def mesh_tokens(cfg, device):
    import torch

    g = torch.Generator(device=device).manual_seed(MESH_SEED)
    return torch.randn((1, MESH_TOKENS, cfg.d_model), generator=g, device=device).to(
        cfg.compute_dtype)


def moe_dropped(x, p, cfg, model_size: int) -> int:
    """The replicas moe_ep drops over ``model_size`` ranks along ``tp``: its
    routing (``moe._route``) recomputed, each peer's replicas past
    ``moe.capacity``."""
    import torch

    from repro_torch.models import moe

    x2d = x.reshape(-1, cfg.d_model)
    _, idx, _ = moe._route(x2d, p["router"], cfg)
    tk = idx.numel()
    cap = moe.capacity(tk, model_size, cfg.capacity_factor)
    peer = torch.div(idx.reshape(-1), cfg.n_experts // model_size, rounding_mode="floor")
    counts = torch.bincount(peer, minlength=model_size)
    return int((counts - cap).clamp(min=0).sum())


def mesh_vp_share(src, dst, n: int, shape, rank: int):
    """A rank's share of the dst-sorted lanes for the mesh ``shape`` (node
    blocks along "data", split along "model"): its block's lanes padded to
    a multiple of the split with id ``MESH_VP_ROWS`` (outside every block)
    and src ``n`` (a zero message), then its slice, as the reference's
    ``P(all_axes)`` hands them out (tests/test_distributed.py's layout)."""
    blocks, sub = shape
    block = MESH_VP_ROWS // blocks
    bounds = np.searchsorted(dst, np.arange(0, MESH_VP_ROWS + 1, block))
    per = int(-(-int(np.diff(bounds).max()) // sub) * sub)
    b, j = divmod(rank, sub)
    ids = np.full(per, MESH_VP_ROWS, np.int32)
    ss = np.full(per, n, np.int32)
    lo, hi = bounds[b], bounds[b + 1]
    ids[:hi - lo], ss[:hi - lo] = dst[lo:hi], src[lo:hi]
    w = per // sub
    return ss[j * w:(j + 1) * w], ids[j * w:(j + 1) * w]


def mesh_messages(src, n: int, device):
    """[E, 16] float32 messages ``h[src]`` of seeded node features, zero for
    the sentinel src ``n``."""
    import torch

    g = torch.Generator(device=device).manual_seed(MESH_SEED + 1)
    h = torch.randn((n, MESH_VP_D), generator=g, device=device)
    vals = h.index_select(0, src.clamp(max=n - 1))
    return vals.masked_fill_((src >= n)[:, None], 0.0)


def _mesh_rank(rank: int, world: int, init: str, data: str, out: str,
               device: str = "cuda") -> None:
    """One rank of phase 13's sub-axis world 2: a gloo group, both ranks on
    cuda:0. Over the (1, 2) mesh, grok-1's MoE layer through ``moe_tp`` and
    deepseek-v3's through ``moe_ep`` from this rank's seeded shard; the
    collectives alone at the paths' sizes; ``vp_segment_sum`` over the
    (2, 1) and (1, 2) meshes on this rank's share of ogbn-products' lanes,
    K1 on and off. Writes its answers, counts and times to ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import collective, distributed
    from repro_torch.kernels import ops, segsum
    from repro_torch.models import moe, moe_ep, moe_tp

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        segsum.load_library()  # built by the parent's phase 1: a load, not a build
    dev = "cuda:0" if on_card else device
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    res = {}
    try:
        meshes = {s: distributed.make_mesh(s, MESH_AXES, device=dev) for s in ((1, 2), (2, 1))}
        mesh = meshes[(1, 2)]
        for name, kind in MESH_MOE:
            cfg = get_arch(name).full.moe
            p = mesh_moe_layer(cfg, kind, dev, mesh)
            x = mesh_tokens(cfg, dev)
            fn = moe_tp if kind == "tp" else moe_ep
            site = ("all_reduce_sum", ("model",)) if kind == "tp" else ("all_to_all", ("model",))
            with torch.inference_mode():
                before = collective.calls[site]
                y, aux = fn(x, p, cfg, mesh=mesh)
                n_site = collective.calls[site] - before
                again, aux2 = fn(x, p, cfg, mesh=mesh)
                res[f"{name}/bitwise"] = np.array(torch.equal(y, again) and torch.equal(aux, aux2))
                res[f"{name}/wall_s"] = np.array(wall_s(lambda: fn(x, p, cfg, mesh=mesh),
                                                        MESH_TIMED))
                res[f"{name}/dropped"] = np.array(
                    moe_dropped(x, p, cfg, mesh.axis_size("model")) if kind == "ep" else 0)
            res[f"{name}/y"] = y.float().cpu().numpy()
            res[f"{name}/aux"] = np.array(float(aux))
            res[f"{name}/site_calls"] = np.array(n_site)
            res[f"{name}/weight_bytes"] = np.array(sum(t.numel() * t.element_size()
                                                       for t in p.values()))
            res[f"{name}/peak_bytes"] = np.array(torch.cuda.max_memory_allocated()
                                                 if on_card else 0)
            del p, x, y, again
            if on_card:
                torch.cuda.empty_cache()

        # the collectives alone at the paths' sizes, every rank together
        ds = get_arch("deepseek-v3-671b").full.moe
        grok = get_arch("grok-1-314b").full.moe
        cap = moe.capacity(MESH_TOKENS * ds.top_k, 2, ds.capacity_factor)
        cases = [
            ("all_to_all", (2, cap, ds.d_model), torch.bfloat16, "moe_ep's replicas",
             lambda t: collective.all_to_all(t, mesh, "model")),
            ("all_reduce_sum", (MESH_TOKENS * grok.top_k, grok.d_model), torch.bfloat16,
             "moe_tp's partial products", lambda t: collective.all_reduce_sum(t, mesh, "model")),
            ("all_reduce_sum", (MESH_VP_ROWS, MESH_VP_D), torch.float32,
             "vp_segment_sum over (1, 2)", lambda t: collective.all_reduce_sum(t, mesh, "model")),
            ("all_gather", (MESH_VP_ROWS // 2, MESH_VP_D), torch.float32,
             "vp_segment_sum's blocks over (2, 1)",
             lambda t: collective.all_gather(t, meshes[(2, 1)], "data")),
        ]
        coll = {}
        for site, shape, dt, what, fn in cases:
            t = torch.ones(shape, dtype=dt, device=dev)
            fn(t.clone())
            coll[f"{site} {list(shape)} {str(dt)[6:]} ({what})"] = wall_s(
                lambda: fn(t.clone()), MESH_TIMED)
            del t
        res["collective_wall_s"] = np.array(json.dumps(coll))

        # vp_segment_sum at ogbn-products' size
        src_all = np.load(Path(data) / "src.npy", mmap_mode="r")
        dst_all = np.load(Path(data) / "dst.npy", mmap_mode="r")
        n = int(np.load(Path(data) / "n.npy"))
        for shape, mesh in meshes.items():
            key = f"vp/{shape[0]}x{shape[1]}"
            ss, ids = mesh_vp_share(src_all, dst_all, n, shape, rank)
            src = torch.from_numpy(np.ascontiguousarray(ss)).to(dev)
            ids = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
            vals = mesh_messages(src, n, dev)
            del src
            with torch.inference_mode(), ops.segment_output_sharding(mesh, ("data",)):
                k1 = segsum.launches
                on = ops.vp_segment_sum(vals, ids, MESH_VP_ROWS, kernel=True)
                res[f"{key}/k1_launches"] = np.array(segsum.launches - k1)
                again = ops.vp_segment_sum(vals, ids, MESH_VP_ROWS, kernel=True)
                res[f"{key}/bitwise"] = np.array(torch.equal(on.view(torch.int32),
                                                             again.view(torch.int32)))
                del again
                off = ops.vp_segment_sum(vals, ids, MESH_VP_ROWS, kernel=False)
                res[f"{key}/on_off"] = np.array(float((on - off).abs().max()))
                res[f"{key}/on_off_ok"] = np.array(bool(torch.allclose(
                    on, off, rtol=GNN_TOL[0], atol=GNN_TOL[1])))
                del off
                full = collective.all_gather(on, mesh, "data")
                res[f"{key}/out"] = full.cpu().numpy()
                del full
                res[f"{key}/wall_s"] = np.array(wall_s(
                    lambda: ops.vp_segment_sum(vals, ids, MESH_VP_ROWS, kernel=True), MESH_TIMED))
                # K1 alone on this rank's block, the ranks in turn (a sum as
                # the barrier), so that the other rank's work is not in it
                rows = MESH_VP_ROWS // shape[0]
                rel = ids - mesh.axis_index("data") * rows
                lanes = int(ids.shape[0])
                k1_ms = []
                for r in range(world):
                    collective.all_reduce_sum(torch.zeros(1, device=dev), mesh)
                    if mesh.rank == r and on_card:
                        k1_ms.append(graph_ms(lambda: segsum.segment_sum_sorted(
                            vals, rel, num_segments=rows), 5))
                collective.all_reduce_sum(torch.zeros(1, device=dev), mesh)
                b, by = bound_ms(lanes * MESH_VP_D * 4 + lanes * 4 + rows * MESH_VP_D * 4,
                                 lanes * MESH_VP_D)
                res[f"{key}/k1"] = np.array(json.dumps(dict(
                    lanes=lanes, rows=rows, device_ms=k1_ms[0] if k1_ms else None,
                    bound_ms=b, bound_by=by)))
            del vals, ids, rel, on
            if on_card:
                torch.cuda.empty_cache()
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def mesh_world1(device) -> tuple[dict, dict]:
    """World 1 of the sub-axis phase, in this process: each MoE layer whole
    (``mesh=None``) and ``moe_dense`` on the same seeded weights and tokens,
    then ogbn-products' graph (61,859,140 seeded pairs, as phase 16 (c)
    builds it) partitioned by ``partition_by_dst_block`` and world 1's
    ``segment_sum`` (K1) of its messages. Returns (answers, the sorted lanes
    for the ranks), every card tensor freed."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.graphs import Graph
    from repro_torch.graphs.partition import partition_by_dst_block
    from repro_torch.kernels import ops
    from repro_torch.models import moe, moe_dense, moe_ep, moe_tp

    out = {}
    for name, kind in MESH_MOE:
        cfg = get_arch(name).full.moe
        torch.cuda.reset_peak_memory_stats()
        p = mesh_moe_layer(cfg, kind, device)
        x = mesh_tokens(cfg, device)
        fn = moe_tp if kind == "tp" else moe_ep
        with torch.inference_mode():
            y, aux = fn(x, p, cfg)
            wall = wall_s(lambda: fn(x, p, cfg), MESH_TIMED)
            # the oracle in blocks of 256 tokens (its [T, E, D] products),
            # its aux over all of them
            dense = torch.cat([moe_dense(x[:, i:i + 256], p, cfg)[0]
                               for i in range(0, MESH_TOKENS, 256)], dim=1)
            aux_d = moe._route(x.reshape(-1, cfg.d_model), p["router"], cfg)[2]
        out[name] = dict(y=y.float().cpu(), aux=float(aux), dense=dense.float().cpu(),
                         aux_dense=float(aux_d), wall_s=wall,
                         to_dense=normwise(y, dense),
                         peak_bytes=torch.cuda.max_memory_allocated())
        del p, x, y, dense
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rng = np.random.default_rng(GNN_PRODUCTS["seed"])
    g = Graph.from_edges(rng.integers(0, GNN_PRODUCTS["n"], (GNN_PRODUCTS["pairs"], 2)),
                         GNN_PRODUCTS["n"])
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    src, dst, _ = partition_by_dst_block(g, 2)
    t_part = time.perf_counter() - t0
    n = g.n_nodes
    del g
    s = torch.from_numpy(src).to(device)
    d = torch.from_numpy(dst).to(device)
    vals = mesh_messages(s, n, device)
    del s
    with torch.inference_mode():
        want = ops.segment_sum(vals, d, num_segments=MESH_VP_ROWS)
    out["vp"] = dict(want=want.cpu().numpy(), lanes=int(dst.shape[0]), nodes=n,
                     host_graph_s=t_graph, host_partition_s=t_part)
    del vals, d, want
    torch.cuda.empty_cache()
    return out, dict(src=src, dst=dst, n=n)


def phase_mesh(device: str) -> dict:
    """Phase 13's sub-axis world 2: world 1 here (``mesh_world1``), then two
    gloo ranks on the card spawned (``_mesh_rank``), both held to world 1
    and the dense oracle. A rank that fails, or a spawn past
    ``SPAWN_TIMEOUT_S``, fails the smoke. Returns the phase's numbers,
    ``k1_launches`` K1's launches on both ranks."""
    import multiprocessing
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    w1, lanes = mesh_world1(device)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_mesh_"))
    try:
        for k in ("src", "dst"):
            np.save(tmp / f"{k}.npy", lanes[k])
        np.save(tmp / "n.npy", np.array(lanes["n"]))
        PRODUCTS_LANES.update(lanes)   # phase 19's GCN step reads them again
        del lanes
        ctx = multiprocessing.get_context("spawn")
        init = f"file://{tmp / 'rendezvous'}"
        outs = [tmp / f"rank{r}.npz" for r in range(2)]
        procs = [ctx.Process(target=_mesh_rank,
                             args=(r, 2, init, str(tmp), str(outs[r]), device))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        check(not hung,
              f"mesh world 2: {len(hung)} rank(s) still running after {SPAWN_TIMEOUT_S} s")
        check(all(p.exitcode == 0 for p in procs),
              f"mesh world 2: rank exit codes {[p.exitcode for p in procs]}")
        spawn_s = time.perf_counter() - t0
        ranks = [dict(np.load(o)) for o in outs]  # read into memory before the files go
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = card_line()
    res = dict(spawn_s=spawn_s, card=card)
    for name, kind in MESH_MOE:
        want = w1[name]
        site = "one sum over 'model'" if kind == "tp" else "three all-to-alls over 'model'"
        to_w1, to_dense = [], []
        for r, rk in enumerate(ranks):
            y = torch.from_numpy(rk[f"{name}/y"])
            to_w1.append(normwise(y, want["y"]))
            to_dense.append(normwise(y, want["dense"]))
            check(to_w1[r] <= LM_MOE_NORMWISE and to_dense[r] <= LM_MOE_NORMWISE,
                  f"{name} world 2 rank {r}: {to_w1[r]} from world 1, {to_dense[r]} from "
                  f"moe_dense (normwise, <= {LM_MOE_NORMWISE})")
            aux = float(rk[f"{name}/aux"])
            # without sp every rank routes world 1's tokens: the same aux
            check(abs(aux - want["aux"]) <= MESH_AUX_RTOL * abs(want["aux"]),
                  f"{name} world 2 rank {r}: aux {aux} vs world 1's {want['aux']} "
                  f"(rtol {MESH_AUX_RTOL})")
            check(abs(aux - want["aux_dense"]) <= 0.2 * abs(want["aux_dense"]),
                  f"{name} world 2 rank {r}: aux {aux} vs moe_dense's {want['aux_dense']}")
            check(bool(rk[f"{name}/bitwise"]), f"{name} world 2 rank {r}: two runs differ")
            check(int(rk[f"{name}/site_calls"]) == (1 if kind == "tp" else 3),
                  f"{name} world 2 rank {r}: {int(rk[f'{name}/site_calls'])} calls, not {site}")
            check(int(rk[f"{name}/dropped"]) == 0,
                  f"{name} world 2 rank {r}: {int(rk[f'{name}/dropped'])} replicas dropped")
        res[name] = dict(world1_wall_s=want["wall_s"], world1_to_dense=want["to_dense"],
                         world1_peak_bytes=want["peak_bytes"],
                         world2_wall_s=[list(map(float, rk[f"{name}/wall_s"])) for rk in ranks],
                         world2_to_world1=to_w1, world2_to_dense=to_dense,
                         aux=[float(rk[f"{name}/aux"]) for rk in ranks], aux_world1=want["aux"],
                         aux_dense=want["aux_dense"],
                         dropped=[int(rk[f"{name}/dropped"]) for rk in ranks],
                         weight_bytes_a_rank=int(ranks[0][f"{name}/weight_bytes"]),
                         peak_bytes_a_rank=[int(rk[f"{name}/peak_bytes"]) for rk in ranks])
        log(f"  mesh world 2 (gloo, both ranks on {device}:0): {name}'s MoE layer at published "
            f"widths through {'moe_tp' if kind == 'tp' else 'moe_ep'} over (1, 2) "
            f"('data', 'model'), {MESH_TOKENS} tokens: == world 1 within {to_w1} and == "
            f"moe_dense within {to_dense} normwise by rank (<= {LM_MOE_NORMWISE}), aux by "
            f"rank {res[name]['aux']} vs world 1 {want['aux']} and dense {want['aux_dense']}, "
            f"{site} a layer, replicas dropped by rank {res[name]['dropped']}, bitwise "
            f"repeatable; "
            f"{res[name]['weight_bytes_a_rank']} weight bytes a rank; peak device memory world "
            f"1 {want['peak_bytes']} bytes, world 2 by rank {res[name]['peak_bytes_a_rank']} "
            f"bytes; wall world 1 {want['wall_s']} s, world 2 by rank "
            f"{res[name]['world2_wall_s']} s ({card})")
    vp = w1["vp"]
    k1_launches = 0
    for layout in ("2x1", "1x2"):
        key = f"vp/{layout}"
        for r, rk in enumerate(ranks):
            check(int(rk[f"{key}/k1_launches"]) == 1,
                  f"{key} rank {r}: {int(rk[f'{key}/k1_launches'])} K1 launches, not 1")
            k1_launches += 1
            check(bool(rk[f"{key}/bitwise"]), f"{key} rank {r}: two runs differ")
            on_off = float(rk[f"{key}/on_off"])
            check(bool(rk[f"{key}/on_off_ok"]), f"{key} rank {r}: K1 on and off differ by "
                  f"{on_off} (rtol, atol {GNN_TOL})")
            err = compare(torch.from_numpy(rk[f"{key}/out"]), torch.from_numpy(vp["want"]),
                          MESH_VP_TOL)
            res[f"{key}/rank{r}"] = dict(k1_on_off_max_abs=on_off, to_world1_max_abs=err,
                                         wall_s=list(map(float, rk[f"{key}/wall_s"])),
                                         k1=json.loads(str(rk[f"{key}/k1"])))
        k1 = res[f"{key}/rank0"]["k1"]
        log(f"  mesh world 2: vp_segment_sum over ({layout[0]}, {layout[2]}) on "
            f"ogbn-products' {vp['lanes']} lanes ([E, {MESH_VP_D}] float32, "
            f"{MESH_VP_ROWS} rows): K1 on == off (max abs "
            f"{[res[f'{key}/rank{r}']['k1_on_off_max_abs'] for r in range(2)]}), the gathered "
            f"blocks == world 1's segment_sum (max abs "
            f"{[res[f'{key}/rank{r}']['to_world1_max_abs'] for r in range(2)]}), bitwise "
            f"repeatable, one K1 launch a rank; wall by rank "
            f"{[res[f'{key}/rank{r}']['wall_s'] for r in range(2)]} s; K1 alone on "
            f"{k1['lanes']} lanes / {k1['rows']} rows a rank: device_ms by rank "
            f"{[res[f'{key}/rank{r}']['k1']['device_ms'] for r in range(2)]} against a "
            f"{k1['bound_ms']:.4f} ms {k1['bound_by']} bound ({card})")
    coll = json.loads(str(ranks[0]["collective_wall_s"]))
    res["collective_wall_s"] = {r: json.loads(str(rk["collective_wall_s"]))
                                for r, rk in enumerate(ranks)}
    log(f"  mesh world 2: collective walls (gloo through the host, rank 0, {MESH_TIMED} "
        f"runs): {coll} ({card}); two ranks share one card: no scaling number")
    res.update(k1_launches=k1_launches, host_graph_s=vp["host_graph_s"],
               host_partition_s=vp["host_partition_s"],
               phase_s=time.perf_counter() - t_phase)
    log(f"  mesh world 2 took {res['phase_s']:.3f} s (spawn {spawn_s:.3f} s; host graph "
        f"{vp['host_graph_s']:.3f} s, partition {vp['host_partition_s']:.3f} s)")
    return res


def phase_sharded(g, device: str, peel_answers: dict, cbds_answer: tuple,
                  stream_answers: list, backend: str = "nccl", graph: dict = STREAM_GRAPH,
                  engine: dict = STREAM_ENGINE, events: int = STREAM_EVENTS,
                  coo: dict = SHARD_FUSED) -> tuple[dict, dict]:
    """World 1 on a real NCCL group of one, then world 2. ``graph``,
    ``engine`` and ``events`` are phase 11's, ``coo`` phase 12's lane bucket
    cut. Returns (launches by kernel on the sharded main path, times)."""
    import importlib
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core import collective, distributed
    from repro_torch.graphs.generators import planted_dense
    from repro_torch.stream import DeltaEngine, StreamService

    dispatch = importlib.import_module("repro_torch.core.dispatch")
    sf = importlib.import_module("repro_torch.stream.fused")
    main_launches = {k: 0 for k in launch_counts()}
    main_collectives = [0]

    def on_main(fn):
        before, coll = launch_counts(), collective.collectives
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k, n in launch_counts().items():
            main_launches[k] += n - before[k]
        main_collectives[0] += collective.collectives - coll
        return out, ms

    tmp = tempfile.mkdtemp(prefix="smoke_nccl_")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1,
                            rank=0)
    times, world1 = {}, {}
    try:
        mesh = distributed.make_mesh(device=device)
        check(mesh.device.type == torch.device(device).type and mesh.group is not None
              and mesh.size == 1, f"the {backend} mesh of one: {mesh}")
        log(f"  {backend} group of one: {mesh}")
        zero_launch_counts()
        # P-Bahmani: phase 4's answers, one K2 launch and one collective a pass
        for eps in (0.1, 0.0):
            before, coll = launch_counts(), collective.collectives
            got, ms = on_main(lambda: distributed.pbahmani_distributed(g, mesh, eps=eps,
                                                                       kernel=True))
            d = {k: n - before[k] for k, n in launch_counts().items()}
            n_coll = collective.collectives - coll
            check(same_triple(got, peel_answers[eps]),
                  f"eps={eps}: pbahmani_distributed {got[0]!r}/{got[2]} differs from phase 4's "
                  f"{peel_answers[eps][0]!r}/{peel_answers[eps][2]}")
            check(d["peel_edges"] == got[2] and d["segment_sum_sorted"] == 1
                  and n_coll == got[2] + 1,
                  f"eps={eps}: K2 {d['peel_edges']}, K1 {d['segment_sum_sorted']}, "
                  f"collectives {n_coll} for {got[2]} passes")
            wall = wall_s(lambda: distributed.pbahmani_distributed(g, mesh, eps=eps), 3)
            split = sharded_pass_split(profile_call(
                lambda: distributed.pbahmani_distributed(g, mesh, eps=eps), top=None))
            times[f"pbahmani_{eps}"] = dict(first_ms=ms, wall_s=wall,
                                            median_s=statistics.median(wall), passes=got[2],
                                            collectives=n_coll, split=split)
            if eps == 0.1:
                world1["pb"] = got
            log(f"  pbahmani_distributed eps={eps}: density={got[0]!r} passes={got[2]} == "
                f"phase 4; K2 {d['peel_edges']} (one a pass), K1 1, collectives {n_coll} (the "
                f"degrees' and one a pass); wall median of 3 "
                f"{statistics.median(wall):.6f} s ({wall}); profiled: {split}")
        # CBDS-P: phase 5's dict and coreness
        cb_want, core_want = cbds_answer
        before, coll = launch_counts(), collective.collectives
        cb, ms = on_main(lambda: distributed.cbds_distributed(g, mesh, kernel=True))
        d = {k: n - before[k] for k, n in launch_counts().items()}
        check(all(np.array_equal(cb[k], cb_want[k]) for k in cb_want)
              and np.array_equal(cb["coreness"], core_want),
              f"cbds_distributed {cb['density']!r}/{cb['k_star']} differs from phase 5's")
        check(d["segment_sum_sorted"] == 2 and collective.collectives - coll
              == d["peel_edges"] + 3,
              f"cbds_distributed: K1 {d['segment_sum_sorted']}, K2 {d['peel_edges']}, "
              f"collectives {collective.collectives - coll}")
        wall = wall_s(lambda: distributed.cbds_distributed(g, mesh), 3)
        times["cbds"] = dict(first_ms=ms, wall_s=wall, median_s=statistics.median(wall),
                             k2_launches=d["peel_edges"])
        log(f"  cbds_distributed: density={cb['density']!r} k*={cb['k_star']} == phase 5 "
            f"(coreness too); K2 {d['peel_edges']} (one a fixpoint iteration), K1 2, "
            f"collectives {d['peel_edges'] + 3}; wall median of 3 "
            f"{statistics.median(wall):.6f} s ({wall})")

        # the stream: phase 11's engine sharded, its first batches
        t0 = time.perf_counter()
        gs, _, _ = planted_dense(**graph)
        seed_edges = np.stack([gs.src[:gs.n_edges], gs.dst[:gs.n_edges]], axis=1)
        engines = {"sharded": DeltaEngine(gs.n_nodes, sharded=True, mesh=mesh, **engine),
                   "warm": DeltaEngine(gs.n_nodes, sharded=True, mesh=mesh, pruned=False,
                                       **engine),
                   "single": DeltaEngine(gs.n_nodes, kernel=True, device=device, **engine)}
        sh = engines["sharded"]
        check(sh.n_shards == 1 and not sh.kernel and sh.device == mesh.device,
              f"the sharded engine: {sh!r}")
        rng = np.random.default_rng(1)
        st = {"ingest_ms": [], "query_ms": [], "warm_ms": [], "refine_ms": [], "cbds_ms": [],
              "single_query_ms": []}
        world1["stream"] = []
        for b in range(-1, SHARD_STREAM_BATCHES):
            if b < 0:
                ins, dels = seed_edges, None
            else:
                ins, dels = stream_batches(rng, sh, gs.n_nodes, events)
            for name, eng in engines.items():
                if name == "sharded":
                    _, ms = on_main(lambda: eng.apply_updates(insert=ins, delete=dels))
                    if b >= 0:
                        st["ingest_ms"].append(ms)
                else:
                    eng.apply_updates(insert=ins, delete=dels)
            label = "seed" if b < 0 else f"batch {b}"
            q, ms = on_main(sh.query)
            st["query_ms"].append(ms)
            world1["stream"].append(q)
            torch.cuda.synchronize()  # the single-device engine, timed beside it
            t1 = time.perf_counter()
            qs = engines["single"].query()
            torch.cuda.synchronize()
            st["single_query_ms"].append((time.perf_counter() - t1) * 1e3)
            check(same_answer(q, stream_answers[b + 1]) and same_answer(q, qs),
                  f"{label}: the sharded engine {q.density!r}/{q.passes} differs from phase "
                  f"11's {stream_answers[b + 1].density!r} or the single-device engine's")
            w, ms = on_main(engines["warm"].query)
            st["warm_ms"].append(ms)
            check(same_triple((w.density, w.mask, w.passes), (q.density, q.mask, q.passes))
                  and not w.pruned, f"{label}: the sharded warm peel differs")
            r, ms = on_main(lambda: sh.query(**SHARD_REFINE))
            st["refine_ms"].append(ms)
            check(same_answer(r, engines["single"].query(**SHARD_REFINE)),
                  f"{label}: the sharded refined query differs from the single-device one")
            c, ms = on_main(lambda: sh.cbds())
            st["cbds_ms"].append(ms)
            c1 = engines["single"].cbds()
            check(all(np.array_equal(c[k], c1[k]) for k in c1),
                  f"{label}: the sharded cbds differs from the single-device one")
        st["phase_s"] = time.perf_counter() - t0
        times["stream"] = st
        log(f"  stream: planted_dense({graph}) in DeltaEngine({engine}, "
            f"sharded=True) and a warm twin (pruned=False); the seed and "
            f"{SHARD_STREAM_BATCHES} batches of phase 11, a pruned, warm, refined "
            f"({SHARD_REFINE['max_refine_rounds']} rounds) and cbds query after each: == phase "
            f"11's answers == the single-device engine (kernel on); "
            f"{sh.metrics.n_refreshes} refreshes, {sh.metrics.n_pruned_queries} pruned")
        log("  stream ms (sharded engine; the single-device engine's query beside it): " +
            "; ".join(f"{k} {v}" for k, v in st.items()))

        # the fused+sharded bucket: phase 12's lane bucket cut to 8 tenants
        t0 = time.perf_counter()
        eps, refresh_every = 0.1, 4
        rng = np.random.default_rng(12)
        names = [f"coo{i:02d}" for i in range(coo["tenants"])]
        seeds = {}
        for i, name in enumerate(names):
            if i < coo["planted"]:
                gp, _, _ = planted_dense(coo["n"], coo["clique"], coo["p_background"],
                                         coo["p_planted"], seed=i)
                seeds[name] = (np.stack([gp.src[:gp.n_edges], gp.dst[:gp.n_edges]], axis=1),
                               None)
            else:
                seeds[name] = (rng.integers(0, coo["n"], (3 * coo["n"], 2)), None)
        svcs = {k: StreamService(max_tenants=len(names), fused=True, sharded=k, eps=eps,
                                 refresh_every=refresh_every, coalesce_window_ms=1e9,
                                 device=device, mesh=mesh if k else None)
                for k in (True, False)}
        for k, svc in svcs.items():
            for i, name in enumerate(names):
                r = svc.create_tenant(name, n_nodes=coo["n"], capacity=coo["capacity"],
                                      pruned=i < coo["planted"])
                check(r.ok and r.value["placement"] == ("fused+sharded" if k else "fused"),
                      f"create_tenant {name}: {r}")
        flushes = []
        real_flush, real_sum = sf._flush, collective.all_reduce_sum
        real_rows = dispatch._peel_edges_rows_local

        def counted_flush(batch, members, **kw):
            if not batch.sharded:
                return real_flush(batch, members, **kw)
            shapes, passes = [], []

            def counted_sum(t, m):
                if m is not None:
                    shapes.append(tuple(t.shape))
                return real_sum(t, m)

            collective.all_reduce_sum = counted_sum
            dispatch._peel_edges_rows_local = lambda *a: passes.append(
                tuple(a[2].shape)) or real_rows(*a)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real_flush(batch, members, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                collective.all_reduce_sum, dispatch._peel_edges_rows_local = \
                    real_sum, real_rows
            pass_reductions = [sh_ for sh_ in shapes if len(sh_) == 2 and sh_[1] % 2]
            check(len(pass_reductions) == len(passes)
                  and all(a[0] == b[0] for a, b in zip(pass_reductions, passes)),
                  f"a sharded flush made {len(pass_reductions)} [G, V + 1] all-reduces for "
                  f"{len(passes)} batched passes ({shapes})")
            flushes.append(dict(members=len(members), ms=ms, batched_passes=len(passes),
                                collectives=len(shapes), refine=bool(kw.get("refine")),
                                group=sorted({p[0] for p in passes})))
            return out

        sf._flush = counted_flush
        fused_ms = {"ingest_ms": [], "flush_ms": []}
        try:
            for svc in svcs.values():
                check(svc.ingest_many(seeds).ok, "seeding the fused services failed")
            for rnd in range(SHARD_FUSED_ROUNDS):
                upd = {name: mixed_batch(rng, svcs[True].registry.get(name), coo["n"],
                                         coo["events"]) for name in names}
                r, ms = on_main(lambda: svcs[True].ingest_many(upd))
                check(r.ok and svcs[False].ingest_many(upd).ok, f"round {rnd}: ingest failed")
                fused_ms["ingest_ms"].append(ms)
                tickets = [(svcs[True].submit_density(t), svcs[False].submit_density(t), t)
                           for t in names]
                n, ms = on_main(svcs[True].flush)
                check(n == len(names) and svcs[False].flush() == len(names),
                      f"round {rnd}: the flushes answered {n}")
                fused_ms["flush_ms"].append(ms)
                for a, b, t in tickets:
                    ra, rb = svcs[True].poll(a), svcs[False].poll(b)
                    check(ra.ok and rb.ok and ra.error is None and ra.value == rb.value,
                          f"round {rnd} {t}: {ra} / {rb}")
                    qa = svcs[True].registry.get(t)._cached_query
                    qb = svcs[False].registry.get(t)._cached_query
                    check(same_answer(qa, qb), f"round {rnd} {t}: fused+sharded "
                          f"{qa.density!r}/{qa.passes} differs from fused {qb.density!r}")
            from repro_torch.stream import query_group

            ref_on, ms = on_main(lambda: query_group(
                {t: svcs[True].registry.get(t) for t in names}, **SHARD_REFINE))
            fused_ms["refine_ms"] = ms
            ref_off = query_group({t: svcs[False].registry.get(t) for t in names},
                                  **SHARD_REFINE)
            for t in names:
                check(same_answer(ref_on[t], ref_off[t]), f"refine {t}: sharded differs")
        finally:
            sf._flush = real_flush
        check(any(f["batched_passes"] for f in flushes), "no sharded flush ran a batched pass")
        fused_ms["phase_s"] = time.perf_counter() - t0
        times["fused"] = dict(fused_ms, flushes=flushes)
        log(f"  fused+sharded: {len(names)} tenants of phase 12's lane bucket "
            f"({coo['planted']} pruned), StreamService(fused=True, sharded=True) == "
            f"StreamService(fused=True) (kernel on) at every answer of "
            f"{SHARD_FUSED_ROUNDS} rounds and a refined flush; one [G, V + 1] all-reduce a "
            f"batched pass: " + "; ".join(
                f"{f['members']} members {f['ms']:.3f} ms, {f['batched_passes']} passes "
                f"(G={f['group']}), {f['collectives']} collectives"
                f"{' (refine)' if f['refine'] else ''}" for f in flushes))
        log(f"  fused ms: {fused_ms}")
        launches = dict(main_launches)
        times["collectives"] = main_collectives[0]
    finally:
        dist.destroy_process_group()
    times["world2"] = phase_world2(g, device, seed_edges, gs.n_nodes, engine, events, world1)
    times["mesh"] = phase_mesh(device)
    return launches, times


# ---------------------------------------------------------------------------
# phase 14: the invariant linter, the audited libraries, host syncs a pass
# ---------------------------------------------------------------------------
SYNC_WARNING = "synchronizing CUDA operation"  # torch's sync-debug warning text


def count_syncs(fn) -> tuple[int, object]:
    """(synchronizing calls torch reported, ``fn()``): ``fn`` under
    ``torch.cuda.set_sync_debug_mode("warn")`` with every warning recorded
    (the default filter shows a warning's location once, which would count
    a loop's sync once)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in caught), out


def phase_lint(g, device: str, scale: int, flush_round) -> dict:
    """Lints the port (full catalog, the auditor's live providers) and this
    script (RPR401-402): 0 findings each. Holds the libraries the run loaded
    against the loads found statically (RPR201 on the card), and counts the
    host syncs of warm P-Bahmani at eps 0.1 and 0: they differ by the
    difference in passes, one sync a pass. Prints the syncs of CBDS-P,
    refinement and one fused flush beside their passes."""
    import collections
    import importlib

    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.framework import LOAD_ENTRY, find_library_loads, load_module
    from repro_torch.analysis.rules import rules_by_id
    from repro_torch.core import cbds_p, pbahmani
    from repro_torch.kernels import build
    from repro_torch.obs.audit import AUDITOR

    here = Path(__file__).resolve()
    port = here.parent / "src" / "repro_torch"
    out: dict = {}

    t0 = time.perf_counter()
    result = run_analysis([port], root=here.parent)
    check(not result.findings, "the port has lint findings:\n" + "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in result.findings))
    smoke = run_analysis([here], rules=rules_by_id(["RPR401", "RPR402"]))
    check(not smoke.findings, "chip_smoke.py has collective findings:\n" + "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in smoke.findings))
    suppressed = dict(sorted(collections.Counter(f.rule for f, _ in result.suppressed).items()))
    out["lint"] = dict(files=result.files, findings=0, suppressed=suppressed,
                       smoke_findings=0, lint_s=time.perf_counter() - t0)
    log(f"  lint: 0 findings across {result.files} files of src/repro_torch (full catalog, "
        f"dynamic RPR201) and 0 in chip_smoke.py (RPR401-402); suppressed by rule "
        f"{suppressed}; {out['lint']['lint_s']:.3f} s")

    sites = [site for path in sorted(port.rglob("*.py"))
             for site in find_library_loads(load_module(path))]
    static_entries = {site.entry for site in sites if site.kind != "library"}
    static_sources = {site.source for site in sites if site.kind == "load"}
    audited = set(AUDITOR.providers_snapshot()["kernels"])
    loaded = {source.name for source in build._libs}
    check(audited == static_entries == {LOAD_ENTRY},
          f"the kernels provider yields {sorted(audited)}, the static loads {static_entries}")
    check(loaded == static_sources,
          f"the run loaded {sorted(loaded)}, the static loads name {sorted(static_sources)}")
    out["audit"] = dict(provider=sorted(audited), loaded=sorted(loaded))
    log(f"  RPR201 on the card: the kernels provider yields {sorted(audited)}; the run loaded "
        f"{sorted(loaded)} == the build.load sites found statically")

    syncs = {}
    for eps in (0.1, 0.0):
        pbahmani(g, eps=eps, kernel=True, device=device)  # warm
        n, (_, _, passes) = count_syncs(lambda: pbahmani(g, eps=eps, kernel=True,
                                                         device=device))
        syncs[f"pbahmani eps={eps}"] = dict(syncs=n, passes=passes)
    a, b = syncs["pbahmani eps=0.1"], syncs["pbahmani eps=0.0"]
    want = EXPECTED_PEEL.get(scale, {})
    check(not want or (a["passes"], b["passes"]) == (want[0.1][0], want[0.0][0]),
          f"P-Bahmani took {a['passes']} and {b['passes']} passes")
    check(b["syncs"] - a["syncs"] == b["passes"] - a["passes"],
          f"P-Bahmani's host syncs grew by {b['syncs'] - a['syncs']} for "
          f"{b['passes'] - a['passes']} more passes ({syncs}): not one sync a pass")

    kcore = importlib.import_module("repro_torch.core.kcore")
    batched = importlib.import_module("repro_torch.core.batched")
    with CallCount(kcore, "peel_edges") as stages:
        n, _ = count_syncs(lambda: cbds_p(g, rounds=1, kernel=True, device=device))
    syncs["cbds_p"] = dict(syncs=n, passes=stages.n)  # k-core fixpoint iterations
    n, (_, _, passes) = count_syncs(lambda: pbahmani(g, eps=0.1, refine_rounds=3, kernel=True,
                                                     device=device))
    syncs["refine (3 rounds)"] = dict(syncs=n, passes=passes)
    with CallCount(batched, "select_rows") as rows, CallCount(kcore, "peel_edges") as plans:
        n, _ = flush_round(count_syncs)
    syncs["fused flush"] = dict(syncs=n, passes=rows.n, plan_iterations=plans.n)
    out["syncs"] = syncs
    log("  host syncs (torch.cuda.set_sync_debug_mode('warn')): " + "; ".join(
        f"{k}: {v['syncs']} syncs, {v['passes']} passes"
        + (f", {v['plan_iterations']} plan iterations" if "plan_iterations" in v else "")
        for k, v in syncs.items()))
    log(f"  P-Bahmani: eps 0 makes {b['syncs'] - a['syncs']} more syncs than eps 0.1 in "
        f"{b['passes'] - a['passes']} more passes: one host sync a pass")
    return out


# ---------------------------------------------------------------------------
# phase 15: the training runtime (optim/, checkpoint/, launch/train.py)
# ---------------------------------------------------------------------------
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 3
TRAIN_FAILS = (1, 4)   # before any checkpoint (re-init), and racing the step-3 save
PEEL_FAIL_AT = 2
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6   # tests/test_torch_train.py's STEP_TOL
TRAIN_GRAD_RTOL = 1e-2                # float32 gradient vs float64, normwise (step_against_float64)
# make_optimizer("adamw") at step 1: adamw(3e-4) with optim.adamw's defaults
GATHER_GRAD_ATOL = 1e-5               # g_out ~ N(0, 1): a row of a few terms
ADAMW_STEP1 = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)


def tree_bytes(tree) -> int:
    from repro_torch.utils.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def same_tensors(a, b) -> bool:
    from repro_torch.utils.tree import leaves_with_paths

    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and bool((x == y).all()) for (_, x), (_, y) in zip(la, lb))


def step_against_float64(step, cpu_step, cfg, state, batch) -> dict:
    """Step 1 of the train kind on the card against float64 on the CPU, from
    the same weights and batch (``cpu_step``: the same step on the CPU, the
    path tests/test_torch_train.py holds against JAX). Held:
      * the loss against the CPU's float64 loss, within rtol TRAIN_RTOL;
      * each leaf's mu, (1 - b1) clip g, and nu, (1 - b2) (clip g)^2, against
        the float64 gradient and clip, normwise within TRAIN_GRAD_RTOL (twice
        that for nu). Elementwise float32 is far off at this size: sums of
        65,536 rows through three cross layers cancel, so single entries of
        the card's and the CPU's float32 gradients both miss float64 by up to
        their own size; the CPU float32 step's normwise errors are reported
        beside the card's;
      * every parameter against AdamW's update recomputed in float64 from the
        card's own mu and nu, within rtol TRAIN_RTOL, atol TRAIN_ATOL.
    """
    import torch

    from repro_torch.models import dcn_loss
    from repro_torch.models.recsys import DCNv2

    a = ADAMW_STEP1
    params = state["params"]
    p, o, loss = step.fn(params, state["opt"], batch)
    torch.cuda.synchronize()
    host = {k: v.cpu() for k, v in params.items()}
    t0 = time.perf_counter()
    leaves = {k: v.double().requires_grad_() for k, v in host.items()}
    feed = {k: torch.as_tensor(batch[k]) for k in ("dense", "sparse_ids", "labels")}
    feed["dense"] = feed["dense"].double()
    skeleton = DCNv2(cfg, device="meta")
    with torch.enable_grad():
        loss64 = dcn_loss(skeleton, feed, leaves)
        g64 = dict(zip(leaves, torch.autograd.grad(loss64, list(leaves.values()))))
    out = dict(float64_s=time.perf_counter() - t0, loss=float(loss), loss64=float(loss64.detach()))
    del leaves
    t0 = time.perf_counter()
    cpu_opt = {k: {n: v.cpu() for n, v in t.items()} if isinstance(t, dict) else t.cpu()
               for k, t in state["opt"].items()}
    _, co, _ = cpu_step.fn(host, cpu_opt, batch)
    out["cpu_step_s"] = time.perf_counter() - t0
    norm = float(torch.sqrt(sum(g.square().sum() for g in g64.values())))
    clip = min(1.0, a["grad_clip"] / norm)
    out.update(grad_norm64=norm, by_leaf={})
    for k, g in g64.items():
        ref = {"mu": (1 - a["b1"]) * clip * g, "nu": (1 - a["b2"]) * (clip * g).square()}
        row = {}
        for name, want in ref.items():
            scale = float(want.norm())
            for who, got in (("card", o[name][k]), ("cpu32", co[name][k])):
                row[f"{name}_{who}"] = float((got.cpu().double() - want).norm()) / scale
        mhat = o["mu"][k].cpu().double() / (1 - a["b1"])
        nhat = o["nu"][k].cpu().double() / (1 - a["b2"])
        want = host[k].double() * (1 - a["lr"] * a["weight_decay"]) \
            - a["lr"] * mhat / (nhat.sqrt() + a["eps"])
        err = (p[k].cpu().double() - want).abs()
        row["param_err"] = float(err.max())
        row["param_over"] = int((err > TRAIN_ATOL + TRAIN_RTOL * want.abs()).sum())
        out["by_leaf"][k] = row
        del ref, mhat, nhat, want, err
    del g64, co, cpu_opt, host, p, o
    check(abs(out["loss"] - out["loss64"]) <= TRAIN_RTOL * abs(out["loss64"]),
          f"the card's step-1 loss {out['loss']} is not the float64 loss {out['loss64']}")
    for k, row in out["by_leaf"].items():
        check(row["mu_card"] <= TRAIN_GRAD_RTOL and row["nu_card"] <= 2 * TRAIN_GRAD_RTOL,
              f"{k}: the card's mu/nu are off float64's by {row} (normwise, > "
              f"{TRAIN_GRAD_RTOL} / {2 * TRAIN_GRAD_RTOL}); all leaves: {out['by_leaf']}")
        check(row["param_over"] == 0, f"{k}: the card's AdamW update is off its float64 "
              f"recomputation at {row['param_over']} entries (max {row['param_err']})")
    return out


def gather_grad_ms(tables, ids, iters: int = 5) -> dict:
    """The one-hot bag's gather and its table gradient at the train shape, by
    three routes: ``F.embedding`` on the flattened tables (the port's: a
    sorted, fixed-order backward), ``index_select`` (an atomic
    ``index_add_`` backward) and ``index_select`` under
    ``torch.use_deterministic_algorithms(True)``. For each: the time of a
    forward and backward (CUDA events) and whether two gradients are
    bitwise equal. The port's gradient is held against a float64
    ``index_add_`` on the CPU within GATHER_GRAD_ATOL (a row's few float32
    terms summed in another order)."""
    import torch
    import torch.nn.functional as F

    t, r, d = tables.shape
    flat = (ids[..., 0].long() + torch.arange(t, device=ids.device) * r).reshape(-1)
    leaf = tables.detach().requires_grad_()
    g_out = torch.randn(flat.numel(), d, device=tables.device,
                        generator=torch.Generator(device=tables.device).manual_seed(1))

    def embedding():
        return torch.autograd.grad(F.embedding(flat, leaf.view(t * r, d)), leaf, g_out)[0]

    def index_select():
        return torch.autograd.grad(leaf.view(t * r, d).index_select(0, flat), leaf, g_out)[0]

    want = torch.zeros(t * r, d, dtype=torch.float64).index_add_(
        0, flat.cpu(), g_out.cpu().double())
    err = float((embedding().view(t * r, d).cpu().double() - want).abs().max())
    check(err <= GATHER_GRAD_ATOL, f"F.embedding's table gradient on the card is off a "
          f"float64 index_add_ by {err} (> {GATHER_GRAD_ATOL})")
    out = {"embedding_max_abs_err": err}
    del want
    for name, fn, det in (("embedding", embedding, False), ("index_select", index_select, False),
                          ("index_select_deterministic", index_select, True)):
        before = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(det)
        try:
            a, b = fn(), fn()
            out[name] = dict(ms=time_ms(fn, iters), repeatable=bool(torch.equal(a, b)))
        finally:
            torch.use_deterministic_algorithms(before)
        del a, b
    return out


def phase_train(device: str) -> dict:
    """(a): DCN-v2 training at FULL's widths through the train kind and AdamW:
    step 1 on the card held against float64 on the CPU
    (``step_against_float64``), two uninterrupted runs of TRAIN_STEPS steps,
    bitwise equal, whose first loss is that step's, and a run with
    async checkpoints every TRAIN_CKPT_EVERY steps and failures at TRAIN_FAILS,
    bitwise equal to them. Returns the times."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batches
    from repro_torch.kernels import embed
    from repro_torch.launch import (
        LoopConfig, build_step, make_optimizer, run_training, train_state,
    )
    from repro_torch.models import dcn_init

    torch.set_float32_matmul_precision("highest")
    arch = get_arch("dcn-v2")
    cfg = arch.full
    step = build_step("dcn-v2", "train_batch", device=device)
    b = step.meta["rows"]
    opt = make_optimizer(arch.optimizer)
    out: dict = dict(config=dict(name=cfg.name, tables=(cfg.n_sparse, cfg.table_rows,
                                                        cfg.embed_dim),
                                 multi_hot=cfg.multi_hot, batch=b, optimizer=arch.optimizer))

    def init_state():
        return train_state(dcn_init(cfg, device=device), opt)

    step_ms: list[float] = []

    def step_fn(state, batch, timed=False):
        t0 = time.perf_counter()
        p, o, loss = step.fn(state["params"], state["opt"], batch)
        if timed:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"params": p, "opt": o}, loss

    def data(start):
        return recsys_batches(cfg, b, seed=0, start_step=start)

    first = init_state()
    out["against_float64"] = step_against_float64(
        step, build_step("dcn-v2", "train_batch", device="cpu"), cfg, first, next(data(0)))
    del first
    torch.cuda.empty_cache()
    log(f"  step 1 on the card against float64 on the CPU (loss rtol {TRAIN_RTOL}; mu, nu "
        f"normwise {TRAIN_GRAD_RTOL}, {2 * TRAIN_GRAD_RTOL}; the update rtol {TRAIN_RTOL}, atol "
        f"{TRAIN_ATOL}): {out['against_float64']}")

    loop = LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY)
    k5 = embed.launches
    t0 = time.perf_counter()
    ref = run_training(lambda s, bt: step_fn(s, bt, timed=True), init_state, data, None, loop)
    out["run1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = run_training(step_fn, init_state, data, None, loop)
    out["run2_s"] = time.perf_counter() - t0
    check(again.losses == ref.losses and same_tensors(again.final_state, ref.final_state),
          f"two uninterrupted DCN-v2 runs differ: losses {ref.losses} / {again.losses}")
    del again
    check(embed.launches == k5, "the one-hot train step launched K5")
    check(ref.losses[0] == out["against_float64"]["loss"],
          f"the loop's first loss {ref.losses[0]} is not the step held against float64 "
          f"({out['against_float64']['loss']})")
    out["losses"] = ref.losses
    out["step_ms"] = step_ms
    out["step_median_ms"] = statistics.median(step_ms)
    log(f"  {cfg.name} FULL: {cfg.n_sparse} x {cfg.table_rows} x {cfg.embed_dim} float32 tables, "
        f"multi_hot {cfg.multi_hot}, B={b}, {arch.optimizer}; two uninterrupted runs of "
        f"{TRAIN_STEPS} steps bitwise equal (losses {ref.losses}); step median "
        f"{out['step_median_ms']:.3f} ms ({step_ms}); runs {out['run1_s']:.3f} / "
        f"{out['run2_s']:.3f} s; no K5 launch")

    # the checkpointed run with two failures
    n_bytes = tree_bytes(ref.final_state)
    tmp_root = tempfile.gettempdir()
    free = shutil.disk_usage(tmp_root).free
    out["checkpoint_bytes"], out["free_bytes"] = n_bytes, free
    log(f"  one checkpoint holds {n_bytes} bytes (parameters, mu, nu); {free} bytes free under "
        f"{tmp_root}")
    check(free >= 2 * n_bytes,
          f"the disk under {tmp_root} has {free} bytes free: too small for two checkpoints "
          f"of {n_bytes} bytes (keep=1 holds one beside the one being written)")

    class TimedCheckpoints(CheckpointManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.times = dict(snapshot_s=[], write_s=[], restore_s=[])

        def save(self, step_, state, blocking=False):
            self.wait()  # the snapshot below is timed alone
            t0_ = time.perf_counter()
            host = super().save(step_, state, blocking)
            self.times["snapshot_s"].append(time.perf_counter() - t0_)
            return host

        def _write(self, step_, host_state):
            t0_ = time.perf_counter()
            super()._write(step_, host_state)
            self.times["write_s"].append(time.perf_counter() - t0_)

        def restore(self, target, step=None):
            t0_ = time.perf_counter()
            res_ = super().restore(target, step)
            self.times["restore_s"].append(time.perf_counter() - t0_)
            return res_

    fails = set(TRAIN_FAILS)

    def inject(s):
        if s in fails:
            fails.discard(s)
            raise RuntimeError(f"simulated worker loss at step {s}")

    ckpt_dir = tempfile.mkdtemp(prefix="smoke_train_ckpt_")
    try:
        ckpt = TimedCheckpoints(ckpt_dir, keep=1, async_save=True)
        t0 = time.perf_counter()
        res = run_training(step_fn, init_state, data, ckpt, loop, failure_injector=inject)
        out["failure_run_s"] = time.perf_counter() - t0
        out["checkpoint_steps"] = ckpt.all_steps()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    want = ref.losses[:1] + ref.losses[:4] + ref.losses[3:]
    check(res.restarts == 2, f"the failure run restarted {res.restarts} times, not 2")
    check(res.losses == want, f"the failure run's losses {res.losses} are not {want}")
    check(same_tensors(res.final_state, ref.final_state),
          "the run with two failures ends with other tensors than the uninterrupted run")
    del res
    out.update({k: v for k, v in ckpt.times.items()})
    # writes: steps 3 and 6 on the thread, and the loop's final blocking save
    check(len(ckpt.times["restore_s"]) == 1 and len(ckpt.times["write_s"]) == 3,
          f"checkpoint calls {ckpt.times}")
    log(f"  failures at steps {TRAIN_FAILS} (re-init, then a restore racing the step-3 save): "
        f"restarts 2, losses and every final parameter, mu, nu and step bitwise equal to the "
        f"uninterrupted run; run {out['failure_run_s']:.3f} s; save host snapshots "
        f"{ckpt.times['snapshot_s']} s, writes {ckpt.times['write_s']} s, restore "
        f"{ckpt.times['restore_s']} s (keep=1, steps left {out['checkpoint_steps']})")

    # the optimizer update against its bound, and the gather's backward by route
    params, state = ref.final_state["params"], ref.final_state["opt"]
    grads = {k: v * 1e-3 for k, v in params.items()}
    n_params = sum(v.numel() for v in params.values())
    out["update_ms"] = time_ms(lambda: opt.update(grads, state, params), iters=5)
    out["update_bound_ms"] = 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    log(f"  {arch.optimizer} update of {n_params} float32 parameters: "
        f"{out['update_ms']:.3f} ms against a {out['update_bound_ms']:.3f} ms bound (7 reads "
        f"and writes of float32 a parameter at {HBM_BYTES_PER_S / 1e12} TB/s)")
    ids = torch.as_tensor(next(data(0))["sparse_ids"], device=device)
    out["gather_grad"] = gather_grad_ms(params["tables"], ids)
    check(out["gather_grad"]["embedding"]["repeatable"],
          "F.embedding's table gradient differs between two runs")
    log(f"  the one-hot bag's gather + table gradient at B={b}: {out['gather_grad']} "
        f"(the port keeps F.embedding)")
    del grads, params, state, ref
    torch.cuda.empty_cache()
    return out


def phase_peel_restarts(g, device: str, peel_answer: tuple, sharded_median_s: float,
                        backend: str = "nccl", timed_runs: int = 3) -> tuple[dict, dict]:
    """(b): ``peel_with_restarts`` on the RMAT graph at eps 0.1 over a group
    of one (phase 13's world), a failure at pass PEEL_FAIL_AT: phase 4's
    triple bit for bit, K1 once, K2 once a pass, one collective for the
    degrees and one a pass, one restore. Returns (launches on its main path,
    times)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import collective, distributed
    from repro_torch.launch import peel_with_restarts

    class CountedRestores(CheckpointManager):
        """Counts restores; times the loop's save calls (the snapshot and the
        wait for the last write) and the writes on the thread."""
        restores = 0
        save_s: list = []
        write_s: list = []

        def restore(self, target, step=None):
            CountedRestores.restores += 1
            return super().restore(target, step)

        def save(self, step_, state, blocking=False):
            t0_ = time.perf_counter()
            host = super().save(step_, state, blocking)
            CountedRestores.save_s.append(time.perf_counter() - t0_)
            return host

        def _write(self, step_, host_state):
            t0_ = time.perf_counter()
            super()._write(step_, host_state)
            CountedRestores.write_s.append(time.perf_counter() - t0_)

    tmp = tempfile.mkdtemp(prefix="smoke_restarts_")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1,
                            rank=0)
    out: dict = {}
    try:
        mesh = distributed.make_mesh(device=device)
        zero_launch_counts()
        coll = collective.collectives
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = peel_with_restarts(g, mesh, 0.1, CountedRestores(f"{tmp}/main", keep=2),
                                 fail_at_pass=PEEL_FAIL_AT)
        torch.cuda.synchronize()
        out["main_s"] = time.perf_counter() - t0
        launches = launch_counts()
        n_coll = collective.collectives - coll
        triple = (got["density"], got["mask"], got["passes"])
        check(same_triple(triple, peel_answer),
              f"peel_with_restarts {got['density']!r}/{got['passes']} differs from phase 4's "
              f"{peel_answer[0]!r}/{peel_answer[2]}")
        check(launches["peel_edges"] == got["passes"] and launches["segment_sum_sorted"] == 1
              and n_coll == got["passes"] + 1 and CountedRestores.restores == 1,
              f"K2 {launches['peel_edges']}, K1 {launches['segment_sum_sorted']}, collectives "
              f"{n_coll}, restores {CountedRestores.restores} for {got['passes']} passes")
        walls = []
        for i in range(timed_runs):
            CountedRestores.save_s, CountedRestores.write_s = [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            peel_with_restarts(g, mesh, 0.1, CountedRestores(f"{tmp}/timed{i}", keep=2))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        state_bytes = 4 * g.n_nodes + 2 * g.n_nodes + 4 * 4
        out.update(wall_s=walls, median_s=statistics.median(walls), passes=got["passes"],
                   collectives=n_coll, restores=CountedRestores.restores,
                   checkpoint_bytes=state_bytes, sharded_median_s=sharded_median_s,
                   last_run_save_calls_s=CountedRestores.save_s,
                   last_run_writes_s=CountedRestores.write_s)
        log(f"  peel_with_restarts eps=0.1, fail at pass {PEEL_FAIL_AT}: density="
            f"{got['density']!r} passes={got['passes']} == phase 4 (and so phase 13) bit for "
            f"bit; K2 {launches['peel_edges']} (one a pass), K1 1, collectives {n_coll}, one "
            f"restore; {out['main_s']:.6f} s with the failure; wall median of {timed_runs} "
            f"without {out['median_s']:.6f} s ({walls}) against phase 13's "
            f"pbahmani_distributed {sharded_median_s:.6f} s: a checkpoint of {state_bytes} "
            f"bytes a pass; the last run's save calls (snapshot, wait for the last write) "
            f"{CountedRestores.save_s} s, writes on the thread {CountedRestores.write_s} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, out


# ---------------------------------------------------------------------------
# phase 16: the GNN zoo (models/gnn.py) over K1's [E, D] float32 path
# ---------------------------------------------------------------------------
GNN_ARCHS = ("gcn-cora", "schnet", "egnn", "mace")
GNN_CORA = dict(n=2708, pairs=10_556, seed=0)            # full_graph_sm's size
GNN_MOLECULE = (30, 64, 128)                              # GraphBatcher: the molecule shape
GNN_PRODUCTS = dict(n=2_449_029, pairs=61_859_140, seed=0)   # ogb_products' size
GNN_SEEDS, GNN_FANOUT = 1024, (15, 10)                    # minibatch_lg's block
GNN_TRAIN_STEPS = 30
GNN_TOL = (1e-4, 1e-5)       # kernel on vs off: float32 sums in another order (rtol, atol)
GNN_F64_RTOL = 1e-4          # float32 outputs and losses vs float64, normwise
GNN_GRAD_RTOL = 1e-3         # float32 gradients (mu, nu) vs float64, normwise, each leaf
GNN_SYM_TOL = (2e-3, 2e-4)   # tests/test_models_gnn.py's symmetry tolerance
# K1 at the GNN's widths: (lanes of which path, D); [E, 64] and wider at the
# ogb_products lanes would take 32 GB and more a copy. D = 7 is gcn-cora's
# second-layer sum (n_classes) at ogb_products' size, on the main path.
GNN_K1_POINTS = (("ogb_products", 1), ("ogb_products", 16), ("ogb_products", 7),
                 ("minibatch_lg", 1), ("minibatch_lg", 16), ("minibatch_lg", 64),
                 ("minibatch_lg", 1152))


def gnn_feed(batch: dict, device, dtype=None) -> dict:
    """A numpy batch as tensors on ``device`` (floats as ``dtype`` when given)."""
    import torch

    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.as_tensor(v, device=device)
            if dtype is not None and v.is_floating_point():
                v = v.to(dtype)
        out[k] = v
    return out


def gnn_model(arch: str, cfg, device, seed: int = 0):
    import torch

    from repro_torch.models import gnn

    init = {"gcn-cora": gnn.gcn_init, "schnet": gnn.schnet_init, "egnn": gnn.egnn_init,
            "mace": gnn.mace_init}[arch]
    return init(cfg, device=device, generator=torch.Generator(device=device).manual_seed(seed))


def close(a, b, tol) -> float:
    """``compare`` over a tensor or a tuple of them (EGNN's energies and
    positions), each finite."""
    import torch

    err = 0.0
    for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
        check(bool(torch.isfinite(x).all()), f"non-finite values in {tuple(x.shape)}")
        err = max(err, compare(x, y, tol))
    return err


def normwise(got, want) -> float:
    """||got - want|| / ||want|| in float64 (0 when both are 0)."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.norm())
    diff = float((got - want).norm())
    return diff / scale if scale else (0.0 if diff == 0 else float("inf"))


def gnn_on_off(model, feed) -> dict:
    """The forward with K1 on (twice: bitwise equal) and off on one module,
    under no_grad; the on forward's K1 launches and sorts."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops, segsum

    cfg = model.cfg
    try:
        model.cfg = dataclasses.replace(cfg, kernel=True)
        k1, sorts = segsum.launches, ops.unsorted_fallback_count
        with torch.no_grad():
            on = model(feed)
            torch.cuda.synchronize()
            launches, n_sorts = segsum.launches - k1, ops.unsorted_fallback_count - sorts
            again = model(feed)
            model.cfg = dataclasses.replace(cfg, kernel=False)
            off = model(feed)
        torch.cuda.synchronize()
    finally:
        model.cfg = cfg
    on_t, again_t = (on if isinstance(on, tuple) else (on,)), (
        again if isinstance(again, tuple) else (again,))
    check(all(torch.equal(a, b) for a, b in zip(on_t, again_t)),
          f"{cfg.name}: two forwards with K1 differ")
    # one sort of the edge lanes a forward, and one of the readout's graph ids
    want_sorts = 1 if cfg.name.startswith("gcn") else 2
    check(n_sorts == want_sorts and launches > n_sorts,
          f"{cfg.name}: {launches} K1 launches after {n_sorts} sorts, not {want_sorts}")
    return dict(on=on, off=off, k1_launches=launches, sorts=n_sorts,
                err=close(off, on, GNN_TOL))


def gnn_float64(arch: str, model, batch: dict, step_out, loss_fn) -> dict:
    """The card's step-1 loss and moments against float64 on the CPU from the
    same weights and batch: the loss within GNN_F64_RTOL, each leaf's mu
    ((1 - b1) clip g) and nu ((1 - b2) (clip g)^2) normwise within
    GNN_GRAD_RTOL (a leaf the loss does not reach is 0 on both)."""
    import copy

    import torch

    a = ADAMW_STEP1
    host = copy.deepcopy(model).to("cpu", torch.float64)
    feed = gnn_feed(batch, "cpu", torch.float64)
    params = list(host.parameters())
    with torch.enable_grad():
        loss64 = loss_fn(host, feed)
        grads = torch.autograd.grad(loss64, params, allow_unused=True)
    g64 = {k: torch.zeros_like(p) if g is None else g
           for (k, p), g in zip(host.named_parameters(), grads)}
    norm = float(torch.sqrt(sum(g.square().sum() for g in g64.values())))
    clip = min(1.0, a["grad_clip"] / norm)
    _, opt, loss = step_out
    out = dict(loss=float(loss), loss64=float(loss64.detach()), grad_norm64=norm,
               mu=max(normwise(opt["mu"][k], (1 - a["b1"]) * clip * g) for k, g in g64.items()),
               nu=max(normwise(opt["nu"][k], (1 - a["b2"]) * (clip * g).square())
                      for k, g in g64.items()))
    check(abs(out["loss"] - out["loss64"]) <= GNN_F64_RTOL * abs(out["loss64"]),
          f"{arch}: the card's step-1 loss {out['loss']} is not float64's {out['loss64']}")
    check(out["mu"] <= GNN_GRAD_RTOL and out["nu"] <= 2 * GNN_GRAD_RTOL,
          f"{arch}: the card's moments are off float64's normwise by {out}")
    return out


def gnn_symmetries(arch: str, model, feed) -> dict:
    """Energies invariant under a rotation (SchNet, EGNN, MACE) and EGNN's
    positions equivariant, kernel on, at tests/test_models_gnn.py's
    tolerance."""
    import dataclasses

    import torch

    rng = np.random.default_rng(1)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.diag(r))
    if np.linalg.det(rot) < 0:
        rot[:, 0] = -rot[:, 0]
    rot = torch.as_tensor(rot, dtype=torch.float32, device=feed["pos"].device)
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, kernel=True)
    try:
        with torch.no_grad():
            a = model(feed)
            b = model(dict(feed, pos=feed["pos"] @ rot.T))
    finally:
        model.cfg = cfg
    out = {}
    if arch == "egnn":
        out["positions"] = close(b[1], a[1] @ rot.T, GNN_SYM_TOL)
        a, b = a[0], b[0]
    out["energy"] = close(b, a, GNN_SYM_TOL)
    return out


def molecule_batch(seed: int = 0) -> dict:
    """GraphBatcher's molecule batch (128 graphs of 30 atoms, 64 edges each
    way), with GCN's 32 features and labels beside the geometry."""
    from repro_torch.data import GraphBatcher

    b = GraphBatcher(*GNN_MOLECULE).random_batch(seed=seed)
    rng = np.random.default_rng(seed + 1)
    n = b["graph_id"].shape[0]
    b["node_feat"] = rng.normal(size=(n, 32)).astype(np.float32)
    b["labels"] = rng.integers(0, 7, n).astype(np.int32)
    b["label_mask"] = rng.random(n) < 0.5
    return b


def block_batch(block: dict, d_feat: int, seed: int = 0) -> dict:
    """A model-ready batch of a sampled block, one graph (the shape's
    n_graphs): GCN's features and MACE's geometry drawn from ``seed`` for
    every node, the labels and the readout (MACE's energy) at the seeds, as a
    sampled block's loss is taken; the other nodes carry the messages."""
    rng = np.random.default_rng(seed)
    n = block["n_nodes"]
    at_seeds = np.zeros(n, bool)
    at_seeds[:block["n_seeds"]] = True
    return {"src": block["src"], "dst": block["dst"], "graph_id": np.zeros(n, np.int32),
            "node_mask": at_seeds, "n_graphs": 1,
            "node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
            "labels": rng.integers(0, 7, n).astype(np.int32), "label_mask": at_seeds,
            "atom_type": rng.integers(0, 10, n).astype(np.int32),
            "pos": rng.normal(size=(n, 3)).astype(np.float32),
            "energy": rng.normal(size=1).astype(np.float32)}


def gnn_step_case(arch: str, shape: str, batch: dict, device, seed: int, float64: bool = False,
                  symmetries: bool = False, timed_runs: int = 0) -> dict:
    """One arch at FULL's widths on one shape's batch: the forward with K1
    on against off, one train step (against float64 on the CPU when asked),
    the symmetries, and wall times (median of ``timed_runs``) of the
    forward on / off and of the step, with the peak device memory."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import build_step, make_optimizer, train_state
    from repro_torch.launch.steps import _GNN_FNS

    step = build_step(arch, shape, device=device)
    cfg = get_arch(arch).full
    if arch == "gcn-cora":
        cfg = dataclasses.replace(cfg, d_feat=batch["node_feat"].shape[1])
    model = gnn_model(arch, cfg, device, seed)
    feed = gnn_feed(batch, device)
    feed["n_graphs"] = get_arch(arch).shape(shape).dims.get("batch", 1)
    out = gnn_on_off(model, feed)
    res = dict(k1_launches=out["k1_launches"], on_off_max_abs_err=out["err"])
    del out
    state = train_state(model, make_optimizer("adamw"))
    k1 = launch_counts()
    step_out = step.fn(state["params"], state["opt"], feed)
    torch.cuda.synchronize()
    check(launch_counts() == k1, f"{arch}:{shape}: the train step launched a kernel")
    res["loss"] = float(step_out[2])
    check(np.isfinite(res["loss"]), f"{arch}:{shape}: the step's loss is {res['loss']}")
    if float64:
        res["float64"] = gnn_float64(arch, model, dict(batch, n_graphs=feed["n_graphs"]),
                                     step_out, _GNN_FNS[type(cfg)][1])
    del step_out
    if symmetries and arch != "gcn-cora":
        res["symmetries"] = gnn_symmetries(arch, model, feed)
    if timed_runs:
        on_cfg, off_cfg = (dataclasses.replace(cfg, kernel=k) for k in (True, False))

        def forward(c):
            model.cfg = c
            with torch.no_grad():
                model(feed)

        for label, fn in (("forward_on", lambda: forward(on_cfg)),
                          ("forward_off", lambda: forward(off_cfg)),
                          ("step", lambda: step.fn(state["params"], state["opt"], feed))):
            torch.cuda.reset_peak_memory_stats()
            walls = wall_s(fn, timed_runs)
            res[label] = dict(median_s=statistics.median(walls), wall_s=walls,
                              peak_bytes=torch.cuda.max_memory_allocated())
        res["step_profile"] = profile_call(lambda: step.fn(state["params"], state["opt"], feed),
                                           top=8)
        res["forward_on_profile"] = profile_call(lambda: forward(on_cfg), top=8)
        model.cfg = cfg
    del state, model, feed
    torch.cuda.empty_cache()
    return res


def k1_gnn_point(seg_sorted, seg_unsorted, v: int, d: int, device) -> dict:
    """K1 at one GNN shape: random float32 [E, D] values over the path's own
    ids (sorted, sentinels last); against its plain version, bitwise
    repeatable; ``ms`` (CUDA events over wrapper calls), ``device_ms``
    (CUDA-graph replay), ``plain_ms``, ``library_ms`` (one ``index_add_``
    into V + 1 rows), ``bound_ms`` (each value, id and output once at 3.35
    TB/s, or E * D adds at 67 TFLOP/s), and ``sort_ms``, the forward's one
    stable sort of its edge lanes (``models/gnn.py:_by_dst``: the ids, and
    an int32 lane array carried along)."""
    import torch

    from repro_torch.kernels import ref, segsum

    e = seg_sorted.shape[0]
    gen = torch.Generator(device=device).manual_seed(d)
    vals = torch.randn((e, d) if d > 1 else (e,), generator=gen, device=device)
    a = segsum.segment_sum_sorted(vals, seg_sorted, num_segments=v)
    b = segsum.segment_sum_sorted(vals, seg_sorted, num_segments=v)
    torch.cuda.synchronize()
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          f"K1 [E={e}, D={d}] float32 sums differ between two runs")
    del b
    exp = ref.segment_sum_ref(vals, seg_sorted, v)
    err = compare(a, exp, (1e-5, 1e-5))
    del a, exp
    iters = 3 if e * d > 10**8 else 10
    fn = (lambda: segsum.segment_sum_sorted(vals, seg_sorted, num_segments=v))
    out = dict(lanes=e, d=d, rows=v, max_abs_err=err, ms=time_ms(fn, iters),
               device_ms=graph_ms(fn, iters),
               plain_ms=time_ms(lambda: ref.segment_sum_ref(vals, seg_sorted, v), iters))
    acc = torch.zeros((v + 1,) + tuple(vals.shape[1:]), device=device)
    ids = seg_sorted.clamp(max=v)
    out["library_ms"] = time_ms(lambda: acc.index_add_(0, ids, vals), iters)
    del acc, ids
    out["sort_ms"] = time_ms(lambda: seg_unsorted.index_select(
        0, torch.sort(seg_unsorted, stable=True)[1]), iters)
    del vals
    torch.cuda.empty_cache()
    out["bound_ms"], out["bound_by"] = bound_ms(e * d * 4 + e * 4 + v * d * 4, e * d)
    return out


def phase_gnn(device: str, products: dict = GNN_PRODUCTS, seeds: int = GNN_SEEDS,
              train_steps: int = GNN_TRAIN_STEPS, timed_runs: int = 3) -> tuple[int, dict, dict]:
    """Phase 16: (a) gcn-cora FULL on full_graph_sm's size, (b) the four FULL
    configs on the molecule shape, (c) gcn-cora at ogb_products' size, (d)
    gcn-cora and MACE on minibatch_lg's sampled block, then (e) K1 at the
    GNN's shapes. (a)-(d) are the main path, their K1 launches counted; (e)
    times K1 apart. Returns (K1 launches, K1's [E, D] row, details)."""
    import copy

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import gnn_batch
    from repro_torch.graphs import Graph
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.launch import build_step, make_optimizer, train_state
    from repro_torch.models import gcn_forward

    torch.set_float32_matmul_precision("highest")
    t_phase = time.perf_counter()
    out: dict = {}
    zero_launch_counts()

    # (a) gcn-cora FULL on full_graph_sm's size
    rng = np.random.default_rng(GNN_CORA["seed"])
    cora = Graph.from_edges(rng.integers(0, GNN_CORA["n"], (GNN_CORA["pairs"], 2)),
                            GNN_CORA["n"])
    cfg = get_arch("gcn-cora").full
    batch = gnn_batch(cora, d_feat=cfg.d_feat, n_classes=cfg.n_classes, seed=0)
    model = gnn_model("gcn-cora", cfg, device)
    feed = gnn_feed(batch, device)
    pair = gnn_on_off(model, feed)
    host = copy.deepcopy(model).to("cpu", torch.float64)
    with torch.no_grad():
        want = gcn_forward(host, gnn_feed(batch, "cpu", torch.float64))
    f64 = normwise(pair["on"], want)
    check(f64 <= GNN_F64_RTOL, f"gcn-cora FULL logits off float64 by {f64} normwise")
    step = build_step("gcn-cora", "full_graph_sm", device=device)
    state = train_state(model, make_optimizer("adamw"))
    p, o, losses = state["params"], state["opt"], []
    k1 = launch_counts()
    for _ in range(train_steps):
        p, o, loss = step.fn(p, o, feed)
        losses.append(float(loss))
    check(launch_counts() == k1, "gcn-cora's train steps launched a kernel")
    check(losses[-1] < losses[0], f"gcn-cora's loss did not fall in {train_steps} steps: "
          f"{losses[0]} -> {losses[-1]}")
    out["a_cora"] = dict(nodes=cora.n_nodes, edges=cora.n_edges, k1_launches=pair["k1_launches"],
                         on_off_max_abs_err=pair["err"], float64_normwise=f64,
                         losses=losses)
    log(f"  (a) gcn-cora FULL on |V|={cora.n_nodes} |E|={cora.n_edges} d_feat={cfg.d_feat}: "
        f"K1 on == off (max abs {pair['err']:g}), {pair['k1_launches']} K1 launches a forward, "
        f"logits off float64 by {f64:g} normwise; {train_steps} AdamW steps on the plain path "
        f"(no K1): loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    del model, feed, pair, host, state, p, o, step

    # (b) the four FULL configs on the molecule shape
    mol = molecule_batch(seed=0)
    out["b_molecule"] = {}
    for i, arch in enumerate(GNN_ARCHS):
        res = gnn_step_case(arch, "molecule", mol, device, seed=i, float64=True,
                            symmetries=True)
        out["b_molecule"][arch] = res
        log(f"  (b) {arch} FULL on molecule ({mol['graph_id'].shape[0]} atoms, "
            f"{mol['src'].shape[0]} lanes, 128 graphs): K1 on == off (max abs "
            f"{res['on_off_max_abs_err']:g}), {res['k1_launches']} K1 launches a forward; step "
            f"loss {res['loss']:.6f} vs float64 {res['float64']['loss64']:.6f}, mu / nu normwise "
            f"{res['float64']['mu']:.3g} / {res['float64']['nu']:.3g}"
            + (f"; symmetries {res['symmetries']}" if "symmetries" in res else ""))

    # (c) gcn-cora at ogb_products' size
    t0 = time.perf_counter()
    rng = np.random.default_rng(products["seed"])
    pairs = rng.integers(0, products["n"], (products["pairs"], 2))
    t_pairs = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = Graph.from_edges(pairs, products["n"])
    t_build = time.perf_counter() - t0
    del pairs
    d_feat = get_arch("gcn-cora").shape("ogb_products").dims["d_feat"]
    t0 = time.perf_counter()
    batch = gnn_batch(big, d_feat=d_feat, seed=0)
    t_batch = time.perf_counter() - t0
    res = gnn_step_case("gcn-cora", "ogb_products", batch, device, seed=5, timed_runs=timed_runs)
    res.update(nodes=big.n_nodes, edges=big.n_edges, lanes=int(big.src.shape[0]),
               host_pairs_s=t_pairs, host_graph_build_s=t_build, host_gnn_batch_s=t_batch)
    out["c_products"] = res
    del batch
    log(f"  (c) gcn-cora FULL at ogb_products' size: |V|={big.n_nodes} |E|={big.n_edges} "
        f"lanes={big.src.shape[0]} d_feat={d_feat}; host: pairs {t_pairs:.3f} s, "
        f"Graph.from_edges {t_build:.3f} s, gnn_batch {t_batch:.3f} s; K1 on == off (max abs "
        f"{res['on_off_max_abs_err']:g}), {res['k1_launches']} K1 launches a forward; forward "
        f"on {res['forward_on']['median_s']:.6f} s, off {res['forward_off']['median_s']:.6f} s, "
        f"train step {res['step']['median_s']:.6f} s (median of {timed_runs}); peak "
        f"{res['forward_on']['peak_bytes']} / {res['forward_off']['peak_bytes']} / "
        f"{res['step']['peak_bytes']} bytes; step profile {res['step_profile']}; forward-on "
        f"profile {res['forward_on_profile']}")

    # (d) minibatch_lg: a block of 1,024 seeds sampled from (c)'s graph
    t0 = time.perf_counter()
    sampler = NeighborSampler(big, GNN_FANOUT, seed=0)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    block = sampler.sample(np.random.default_rng(1).choice(big.n_nodes, seeds, replace=False))
    t_sample = time.perf_counter() - t0
    want_shape = sampler.block_shape(seeds)
    check((block["n_nodes"], block["src"].shape[0]) == want_shape,
          f"the block is {block['n_nodes']} nodes, {block['src'].shape[0]} lanes, not {want_shape}")
    feat = 602  # launch/steps.py:_gnn_dims' Reddit-style features for minibatch_lg
    batch = block_batch(block, feat, seed=2)
    out["d_minibatch"] = dict(nodes=block["n_nodes"], lanes=int(block["src"].shape[0]),
                              padded=int((block["node_ids"] < 0).sum()),
                              host_csr_s=t_csr, host_sample_s=t_sample)
    for i, arch in enumerate(("gcn-cora", "mace")):
        res = gnn_step_case(arch, "minibatch_lg", batch, device, seed=10 + i,
                            timed_runs=timed_runs)
        out["d_minibatch"][arch] = res
        log(f"  (d) {arch} FULL on minibatch_lg's block ({block['n_nodes']} nodes, "
            f"{block['src'].shape[0]} lanes, sampled from (c)'s graph: the cut stands in for "
            f"Reddit's 232,965 / 114.6 M, the block's shape is the same): K1 on == off (max abs "
            f"{res['on_off_max_abs_err']:g}), {res['k1_launches']} K1 launches a forward; forward "
            f"on {res['forward_on']['median_s']:.6f} s, off {res['forward_off']['median_s']:.6f} "
            f"s, train step {res['step']['median_s']:.6f} s; peak step "
            f"{res['step']['peak_bytes']} bytes")
    log(f"  (d) host: NeighborSampler's CSR {t_csr:.3f} s, sample {t_sample:.3f} s")
    launches = launch_counts()
    k1 = launches.pop("segment_sum_sorted")
    check(k1 > 0 and not any(launches.values()),
          f"phase 16's main path launched K1 {k1} times and {launches}")
    want_k1 = (out["a_cora"]["k1_launches"] + sum(r["k1_launches"] for r in
                                                   out["b_molecule"].values())
               + out["c_products"]["k1_launches"]
               + sum(out["d_minibatch"][a]["k1_launches"] for a in ("gcn-cora", "mace")))
    # each gnn_on_off runs two forwards with K1, gnn_symmetries two more
    n_sym = sum(2 * r["k1_launches"] for a, r in out["b_molecule"].items() if a != "gcn-cora")
    n_timed = (timed_runs + 2) * (out["c_products"]["k1_launches"] + sum(
        out["d_minibatch"][a]["k1_launches"] for a in ("gcn-cora", "mace"))) if timed_runs else 0
    check(k1 == 2 * want_k1 + n_sym + n_timed,
          f"K1 launched {k1} times; the forwards account for {2 * want_k1 + n_sym + n_timed}")
    out["main_path_s"] = time.perf_counter() - t_phase

    # (e) K1 at the GNN's shapes, apart from the main path
    dst_c = torch.as_tensor(big.dst, device=device)
    lanes = {"ogb_products": (torch.sort(dst_c, stable=True)[0], dst_c, big.n_nodes)}
    blk = torch.as_tensor(block["dst"], device=device)
    lanes["minibatch_lg"] = (torch.sort(blk, stable=True)[0], blk, block["n_nodes"])
    points = []
    for path, d in GNN_K1_POINTS:
        seg_s, seg_u, v = lanes[path]
        p = dict(k1_gnn_point(seg_s, seg_u, v, d, device), path=path)
        points.append(p)
        p["bound_share"] = p["bound_ms"] / p["device_ms"]
        log(f"  (e) K1 [E={p['lanes']}, D={d}] onto {v} rows ({path}): max abs err "
            f"{p['max_abs_err']:g}, bitwise repeatable; ms={p['ms']:.6f} "
            f"device_ms={p['device_ms']:.6f} bound_ms={p['bound_ms']:.6f} ({p['bound_by']}), "
            f"{p['bound_share']:.3f} of the bound; library_ms={p['library_ms']:.6f} (index_add_, "
            f"{p['library_ms'] / p['device_ms']:.3f}x the kernel's device_ms); "
            f"plain_ms={p['plain_ms']:.6f}; the forward's one sort of its lanes "
            f"{p['sort_ms']:.6f} ms")
    del lanes, dst_c, blk
    # the [E, D] path's kernels (segsum.cu's namespace dn): registers,
    # shared memory and spills
    out["k1_ptxas"] = ptxas_records(lambda fn: "dn::" in fn or "2dn" in fn)
    for r in out["k1_ptxas"]:
        log(f"  (e) ptxas {r['source']} {r['function'][:110]}: {r['registers']} registers, "
            f"{r['smem_bytes']} bytes smem, spill {r['spill_store_bytes']} / "
            f"{r['spill_load_bytes']} bytes")
    torch.cuda.empty_cache()
    out["k1_points"] = points
    out["phase_s"] = time.perf_counter() - t_phase
    row = next(p for p in points if (p["path"], p["d"]) == ("ogb_products", 16))
    row = dict(row, max_abs_err=max(p["max_abs_err"] for p in points))
    return k1, row, out


# ---------------------------------------------------------------------------
# phase 17: the transformer family's serving path (models/transformer.py,
# launch/serve.py) at published widths, bfloat16
# ---------------------------------------------------------------------------
LM_SERVE = dict(batch=4, prompt=2048, new=32)   # 4 prompts x 2,048 tokens: the flash path
LM_CUTS = {"deepseek-v3-671b": dict(n_layers=4, n_dense_layers=3),   # 3 dense + 1 MoE
           "grok-1-314b": dict(n_layers=2)}
LM_PREFILL_BATCH = 1                      # prefill_32k, cut from 32
LM_DECODE_BATCH = {"qwen2.5-3b": 8, "phi3-mini-3.8b": 2}   # decode_32k, cut from 128
LM_TIMED = 3                              # median of 3 after a warm call
LM_CONSISTENCY_POS = 16                   # qwen: decode the first 16 positions
# decode vs prefill logits in bfloat16, normwise: unit roundoff 2^-8 a rounding,
# each of qwen's 36 layers rounds its residual update differently in the two
# (products of M = 1 and M = 16 rows), a random walk: sqrt(36 * 2) * 2^-8 * ~1.5
LM_BF16_NORMWISE = 5e-2
# card vs CPU in float32 at "highest": sums of up to 11,008 products in
# another order, sqrt(11008) * 2^-24 = 6e-6 each, a few in series
LM_F32_NORMWISE = 5e-5
LM_MOE_NORMWISE = 1e-2    # moe_ep vs moe_dense in bfloat16: the gate product rounds in bf16
LM_INT8_REL, LM_INT8_AGREE = 0.03, 0.9    # tests/test_models_lm.py's int8 gates, at its config
# phi3 at full depth, int8 cache vs a bfloat16 cache of the same values: each
# layer adds its own quantization error, so the logits' error grows as
# sqrt(depth) (the port on the CPU at phi3's widths in bfloat16: 2.4 % at 3
# layers, 5.3 % at 12): 8-9 % expected at 32. A wrong scale or slot reads
# errors of order 100 %. Greedy agreement is printed, not held: random
# weights' logits are flat (a max near 5 among 32,064 of std ~1.2), so near
# ties flip at this error (62.5 % agreement at 12 layers on the CPU).
LM_INT8_FULL_REL = 0.15
LM_INT8_STEPS = 8


def lm_arch(name: str):
    """The arch with its FULL config cut in depth where LM_CUTS says so."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch = get_arch(name)
    cut = LM_CUTS.get(name)
    return dataclasses.replace(arch, full=dataclasses.replace(arch.full, **cut)) if cut else arch


def lm_step(name: str, shape: str, device):
    """``build_step`` of one LM cell on the (cut) FULL config."""
    from unittest import mock

    from repro_torch.launch import build_step, steps

    with mock.patch.object(steps, "get_arch", lambda _: lm_arch(name)):
        return build_step(name, shape, device=device)


def lm_model(cfg, device, seed: int = 0):
    import torch

    from repro_torch.models import init_params

    return init_params(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(seed))


def lm_prompts(b: int, s: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def fill_cache(cache: dict, seed: int) -> dict:
    """Seeded N(0, 1) entries (scales 1/127, so an int8 entry reads back as
    about N(0, 1)), as a prefilled cache would hold."""
    import torch

    gen = torch.Generator(device=next(iter(cache.values())).device).manual_seed(seed)
    for key, t in cache.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=t.device,
                                  dtype=torch.int8))
        elif key.endswith("_scale"):
            t.fill_(1 / 127)
        else:
            t.normal_(generator=gen)
    return cache


class GroupSizes:
    """Logs each MoE layer's group sizes (``moe._ragged_swiglu``: the one
    host read of a layer) while active: experts hit and rows, for the byte
    bound. Read again here, so use it on calls that are not timed."""

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.real, self.calls = moe, moe._ragged_swiglu, []

        def logged(xs, wg, wi, wo, group_sizes, cd):
            sizes = group_sizes.tolist()
            self.calls.append(dict(experts=sum(1 for n in sizes if n), rows=sum(sizes)))
            return self.real(xs, wg, wi, wo, group_sizes, cd)

        moe._ragged_swiglu = logged
        return self

    def __exit__(self, *exc):
        self.mod._ragged_swiglu = self.real


def lm_param_bytes_read(model, b: int, experts_hit: list[int]) -> int:
    """Bytes of the parameters one decode step of ``b`` tokens reads: every
    matrix of its layers and head, ``b`` rows of the embedding, of each MoE
    layer only the experts its tokens reach (``experts_hit``, one entry a
    MoE layer in order), not the MTP block (serving does not run it)."""
    total = 0
    moe_layer = -1
    for name, p in model.named_parameters():
        if name.startswith("mtp."):
            continue
        if name == "embed":
            total += b * p.shape[1] * p.element_size()
        elif ".moe.w" in name:          # moe.wg / wi / wo: [E, ...] by expert
            if name.endswith(".moe.wg"):
                moe_layer += 1
            total += experts_hit[moe_layer] * p[0].numel() * p.element_size()
        else:
            total += p.numel() * p.element_size()
    return total


def lm_cache_bytes_read(cache: dict, valid: int) -> int:
    """Bytes of the valid cache entries (positions < ``valid``), read once."""
    return sum(t[:, :, :valid].numel() * t.element_size() for t in cache.values())


def lm_decode_point(model, cfg, cache: dict, tok, cache_len: int, label: str) -> dict:
    """One decode step at ``cache_len``: its wall (median of LM_TIMED after a
    warm call; each call writes the same slot), its host syncs (the MoE
    layers' group sizes, nothing else), the bytes it must read against
    3.35 TB/s, and a profile of one step."""
    import torch

    from repro_torch.models import decode_step

    def step():
        return decode_step(model, cache, tok, cache_len, cfg)

    with torch.inference_mode():
        with GroupSizes() as gs:
            logits, _ = step()
        syncs, _ = count_syncs(step)
        check(syncs == cfg.n_moe_layers,
              f"{label}: a decode step made {syncs} host syncs, not one a MoE layer "
              f"({cfg.n_moe_layers})")
        step()
        walls = wall_s(step, LM_TIMED)
        prof = profile_call(step, top=6)
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite decode logits")
    b = tok.shape[0]
    valid = min(cache_len + 1, next(iter(cache.values())).shape[2])
    n_bytes = (lm_param_bytes_read(model, b, [c["experts"] for c in gs.calls])
               + lm_cache_bytes_read(cache, valid) + b * cfg.vocab * 4)
    bound, by = bound_ms(n_bytes, 0)
    ms = statistics.median(walls) * 1e3
    return dict(batch=b, cache_len=cache_len, valid=valid, ms=ms, walls_s=walls,
                tokens_per_s=b / (ms / 1e3), host_syncs=syncs,
                moe_experts_hit=[c["experts"] for c in gs.calls], bytes=n_bytes,
                bound_ms=bound, bound_by=by, bound_share=bound / ms, profile=prof)


def log_decode_point(label: str, p: dict) -> None:
    prof = p["profile"]
    log(f"  {label}: decode step (B={p['batch']}, cache_len={p['cache_len']}, {p['valid']} "
        f"valid entries) {p['ms']:.4f} ms median of {LM_TIMED} ({p['tokens_per_s']:.1f} "
        f"tokens/s), bound {p['bound_ms']:.4f} ms ({p['bytes']} bytes at 3.35 TB/s; "
        f"{100 * p['bound_share']:.1f} % of it); host syncs a step {p['host_syncs']} (the MoE "
        f"group sizes; experts hit {p['moe_experts_hit']}); profiled step: busy "
        f"{prof.get('busy_ms', float('nan')):.4f} ms, idle "
        f"{100 * prof.get('idle_share', float('nan')):.1f} %, "
        f"{prof.get('device_launches')} launches, top {prof.get('top_ms')}")


def lm_serve_case(name: str, device, consistency: bool = False) -> dict:
    """One model through ``serve_batch`` (LM_SERVE): two runs bitwise equal,
    the first token the argmax of the prefill's last logits; the prefill's
    tokens a second and time to the first token (median of LM_TIMED after a
    warm call); a decode step at the serve's cache; peak device memory.
    ``consistency``: the first LM_CONSISTENCY_POS positions decoded from an
    empty cache against the forward's logits."""
    import torch

    from repro_torch.launch import serve_batch
    from repro_torch.models import decode_step, forward, init_cache, prefill

    cfg = lm_arch(name).full
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm_model(cfg, device)
    torch.cuda.synchronize()
    out = dict(layers=cfg.n_layers, params=sum(p.numel() for p in model.parameters()),
               param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
               init_s=time.perf_counter() - t0)
    b, s0, new = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["new"]
    prompts = lm_prompts(b, s0, cfg.vocab, seed=1)
    t0 = time.perf_counter()
    first = serve_batch(model, cfg, prompts, max_new_tokens=new, device=device)
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    again = serve_batch(model, cfg, prompts, max_new_tokens=new, device=device)
    check(first.outputs.shape == (b, new) and np.array_equal(first.outputs, again.outputs),
          f"{name}: two serve_batch runs differ")
    dev_prompts = torch.as_tensor(prompts, device=device)
    with torch.inference_mode():
        last, cache = prefill(model, dev_prompts, cfg)
        check(np.array_equal(first.outputs[:, 0], last.argmax(-1).cpu().numpy()),
              f"{name}: serve_batch's first token is not the argmax of the prefill's last "
              f"logits")
        check(bool(torch.isfinite(last).all()), f"{name}: non-finite prefill logits")

        def ttft():
            return prefill(model, dev_prompts, cfg)[0].argmax(-1).cpu()

        ttft()
        walls = wall_s(ttft, LM_TIMED)
    out["ttft_s"] = statistics.median(walls)
    out["ttft_walls_s"] = walls
    out["prefill_tokens_per_s"] = b * s0 / out["ttft_s"]
    full = {k: torch.zeros((v.shape[0], b, s0 + new, *v.shape[3:]), dtype=v.dtype, device=device)
            for k, v in cache.items()}
    for k, v in cache.items():
        full[k][:, :, :s0] = v
    del cache
    tok = torch.as_tensor(first.outputs[:, 0], device=device)
    out["decode"] = lm_decode_point(model, cfg, full, tok, s0, f"{name} serve")
    del full
    if consistency:
        toks = dev_prompts[:, :LM_CONSISTENCY_POS]
        with torch.inference_mode():
            want, _ = forward(model, toks, cfg)
            c = init_cache(cfg, b, LM_CONSISTENCY_POS, device=device)
            got = torch.stack([decode_step(model, c, toks[:, t], t, cfg)[0]
                               for t in range(LM_CONSISTENCY_POS)], 1)
        err = normwise(got, want)
        check(err <= LM_BF16_NORMWISE, f"{name}: decoding the first {LM_CONSISTENCY_POS} "
              f"positions misses the prefill's logits by {err} normwise")
        out["decode_vs_prefill_normwise"] = err
        del want, got, c
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["model"] = model
    log(f"  {name} ({cfg.n_layers} layers, {out['params']} parameters, {out['param_bytes']} "
        f"bytes bf16, drawn in {out['init_s']:.3f} s): serve_batch of {b} x {s0} tokens + {new} "
        f"new {out['serve_s']:.3f} s, two runs bitwise equal, first token == argmax of the "
        f"prefill; prefill {out['prefill_tokens_per_s']:.1f} tokens/s, time to first token "
        f"{out['ttft_s']:.4f} s (median of {LM_TIMED}: {walls}); peak "
        f"{out['peak_bytes']} bytes"
        + (f"; the first {LM_CONSISTENCY_POS} positions decoded from an empty cache vs "
           f"the prefill's logits {out['decode_vs_prefill_normwise']:.3g} normwise (<= "
           f"{LM_BF16_NORMWISE})" if consistency else ""))
    log_decode_point(f"{name} serve", out["decode"])
    return out


def lm_cell_decode(name: str, shape: str, model, device, batch: int, cache_len: int,
                   seed: int) -> dict:
    """A decode cell through ``build_step``: its cache (``init_cache`` of the
    step's config, seeded entries), a step at ``cache_len`` timed."""
    import torch

    from repro_torch.models import init_cache

    step = lm_step(name, shape, device)
    cfg = step.cfg
    seq = lm_arch(name).shape(shape).dims["seq_len"]
    cache = fill_cache(init_cache(cfg, batch, seq, device=device), seed)
    tok = torch.as_tensor(lm_prompts(batch, 1, cfg.vocab, seed)[:, 0], device=device)
    with torch.inference_mode():
        lg, _ = step.fn(model, cache, tok, cache_len)
    check(bool(torch.isfinite(lg).all()) and tuple(lg.shape) == (batch, cfg.vocab),
          f"{name}:{shape}: the decode kind's logits are {tuple(lg.shape)} or not finite")
    p = lm_decode_point(model, cfg, cache, tok, cache_len, f"{name}:{shape}")
    p.update(cache_entries=next(iter(cache.values())).shape[2],
             cache_bytes=sum(t.numel() * t.element_size() for t in cache.values()),
             window=cfg.sliding_window, meta=step.meta)
    del cache
    log_decode_point(f"{name}:{shape} ({p['cache_entries']}-entry cache, "
                     f"{p['cache_bytes']} bytes, window {cfg.sliding_window})", p)
    return p


def lm_prefill_32k(name: str, model, device) -> dict:
    """prefill_32k through ``build_step`` at batch LM_PREFILL_BATCH: one call
    (the serve runs warmed the path), its logits finite and its cache the
    step's shapes."""
    import torch

    step = lm_step(name, "prefill_32k", device)
    seq = lm_arch(name).shape("prefill_32k").dims["seq_len"]
    toks = lm_prompts(LM_PREFILL_BATCH, seq, step.cfg.vocab, seed=3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last, cache = step.fn(model, toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(last).all()) and all(
        v.shape[1:3] == (LM_PREFILL_BATCH, seq) for v in cache.values()),
        f"{name}:prefill_32k: non-finite logits or a cache of another shape")
    out = dict(batch=LM_PREFILL_BATCH, seq=seq, wall_s=wall,
               tokens_per_s=LM_PREFILL_BATCH * seq / wall,
               peak_bytes=torch.cuda.max_memory_allocated(), meta=step.meta)
    del cache, last
    torch.cuda.empty_cache()
    log(f"  {name}:prefill_32k at batch {LM_PREFILL_BATCH} (cut from 32): one call "
        f"{wall:.3f} s, {out['tokens_per_s']:.1f} tokens/s, peak {out['peak_bytes']} bytes; "
        f"meta model_flops {step.meta['model_flops']:.6g}")
    return out


def lm_float32_on_card(device) -> dict:
    """qwen2.5's FULL widths at 2 layers in float32 (TF32 off), 64 tokens: the
    card's logits against the port's CPU logits from the same weights."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import forward

    cfg = dataclasses.replace(get_arch("qwen2.5-3b").full, n_layers=2,
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    host = lm_model(cfg, "cpu", seed=4)
    toks = torch.as_tensor(lm_prompts(1, 64, cfg.vocab, seed=4))
    with torch.inference_mode():
        want, _ = forward(host, toks, cfg)
        card = copy.deepcopy(host).to(device)
        got, _ = forward(card, toks.to(device), cfg)
    err = normwise(got, want)
    check(err <= LM_F32_NORMWISE, f"qwen2.5 FULL widths, 2 layers, float32: the card's logits "
          f"miss the CPU's by {err} normwise")
    del host, card, want, got
    torch.cuda.empty_cache()
    log(f"  qwen2.5-3b FULL widths at 2 layers, float32, 64 tokens: card vs CPU logits "
        f"{err:.3g} normwise (<= {LM_F32_NORMWISE}) in {time.perf_counter() - t0:.3f} s")
    return dict(normwise=err)


def lm_moe_on_card(model, cfg, device) -> dict:
    """64 tokens through deepseek's MoE layer (256 experts, top-8, 1 shared):
    moe_ep == moe_dense normwise, moe_ep bitwise repeatable."""
    import torch

    from repro_torch.models import moe

    p = model.moe_blocks[0].moe
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator(device=device).manual_seed(5),
                    device=device).to(cfg.compute_dtype)
    with torch.inference_mode():
        ep, aux = moe.moe_ep(x, p, cfg.moe)
        again, _ = moe.moe_ep(x, p, cfg.moe)
        dense, aux_d = moe.moe_dense(x, p, cfg.moe)
    check(torch.equal(ep, again), "deepseek's MoE: two moe_ep calls differ")
    err = normwise(ep, dense)
    check(err <= LM_MOE_NORMWISE and abs(float(aux) - float(aux_d)) <= 1e-6,
          f"deepseek's MoE: moe_ep misses moe_dense by {err} normwise (aux {float(aux)} vs "
          f"{float(aux_d)})")
    log(f"  deepseek-v3 MoE layer (256 experts, top-8, 1 shared) on 64 tokens: moe_ep == "
        f"moe_dense within {err:.3g} normwise (<= {LM_MOE_NORMWISE}), bitwise repeatable")
    return dict(normwise=err)


def lm_int8_jax_case(device) -> dict:
    """tests/test_models_lm.py's test_int8_kv_cache_decode on the card: its
    3-layer float32 config, weights drawn on the CPU (seed 2) and moved, 24
    positions decoded through the int8 cache against the forward's logits:
    <= 3 % relative error, >= 90 % greedy agreement."""
    import copy

    import torch

    from repro_torch.models import TransformerConfig, decode_step, forward, init_cache

    cfg = TransformerConfig(name="t", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                            vocab=101, qkv_bias=True, rope_theta=1e4)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model = copy.deepcopy(lm_model(cfg, "cpu", seed=2)).to(device)
    toks = torch.as_tensor(lm_prompts(2, 24, cfg.vocab, seed=2), device=device)
    with torch.inference_mode():
        ref, _ = forward(model, toks, cfg)
        cache = init_cache(cfg8, 2, 24, device=device)
        dec = torch.stack([decode_step(model, cache, toks[:, t], t, cfg8)[0]
                           for t in range(24)], 1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    check(rel < LM_INT8_REL and agree >= LM_INT8_AGREE,
          f"the int8 decode test's case on the card: rel error {rel}, greedy agreement {agree}")
    log(f"  tests/test_models_lm.py's int8 case on the card (3 layers, float32): rel error "
        f"{rel:.4g} (< {LM_INT8_REL}), greedy agreement {agree:.3f} (>= {LM_INT8_AGREE})")
    return dict(rel_err=rel, greedy_agree=agree)


def lm_int8_decode(device) -> dict:
    """phi3-mini's decode_32k with its int8 cache at batch LM_DECODE_BATCH
    (cut from 128), and the same steps over a bfloat16 cache holding the
    values the int8 one quantizes: relative error within LM_INT8_FULL_REL,
    greedy agreement printed; then the JAX test's own case."""
    import torch

    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.transformer import _quant

    name = "phi3-mini-3.8b"
    cfg = lm_arch(name).full
    b, seq = LM_DECODE_BATCH[name], lm_arch(name).shape("decode_32k").dims["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    model = lm_model(cfg, device, seed=6)
    step = lm_step(name, "decode_32k", device)
    check(step.cfg.kv_cache_dtype == "int8", "phi3's decode_32k runs without its int8 cache")
    cfg16 = dataclasses.replace(cfg, kv_cache_dtype=None)
    c16 = fill_cache(init_cache(cfg16, b, seq, device=device), seed=6)
    c8 = init_cache(step.cfg, b, seq, device=device)
    with torch.inference_mode():
        for key in ("k", "v"):
            for li in range(cfg.n_layers):
                q8, scale = _quant(c16[key][li])
                c8[key][li].copy_(q8)
                c8[f"{key}_scale"][li].copy_(scale)
    start = seq - LM_INT8_STEPS
    toks = torch.as_tensor(lm_prompts(b, LM_INT8_STEPS, cfg.vocab, seed=7), device=device)
    got, want = [], []
    with torch.inference_mode():
        for t in range(LM_INT8_STEPS):
            got.append(step.fn(model, c8, toks[:, t], start + t)[0])
            want.append(decode_step(model, c16, toks[:, t], start + t, cfg16)[0])
    got, want = torch.stack(got, 1).float(), torch.stack(want, 1).float()
    rel = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(rel <= LM_INT8_FULL_REL,
          f"phi3 int8 decode_32k: rel error {rel} against the bf16 cache (greedy agreement "
          f"{agree})")
    tok = toks[:, -1]
    out = dict(rel_err=rel, greedy_agree=agree,
               int8=lm_decode_point(model, step.cfg, c8, tok, seq - 1, f"{name}:decode_32k int8"),
               bf16=lm_decode_point(model, cfg16, c16, tok, seq - 1, f"{name}:decode_32k bf16"))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  {name}:decode_32k at batch {b} (cut from 128) with its int8 cache ("
        f"{sum(t.numel() * t.element_size() for t in c8.values())} bytes) against a bf16 cache "
        f"of the same values: {LM_INT8_STEPS} steps, rel error {rel:.4g} (<= "
        f"{LM_INT8_FULL_REL}), greedy agreement {agree:.3f} (printed); peak "
        f"{out['peak_bytes']} bytes")
    log_decode_point(f"{name}:decode_32k int8", out["int8"])
    log_decode_point(f"{name}:decode_32k bf16 cache", out["bf16"])
    del model, c16, c8
    torch.cuda.empty_cache()
    out["jax_test_case"] = lm_int8_jax_case(device)
    return out


def phase_lm(device: str) -> dict:
    """Phase 17: the five LM configs at published widths (bfloat16, random
    seeded weights, seeded uniform prompts), depth cut where LM_CUTS says:
    qwen2.5-3b (serve_batch, the decode-vs-prefill consistency, prefill_32k,
    decode_32k, long_500k, float32 card vs CPU at 2 layers), mistral-nemo-12b
    (serve_batch), phi3-mini (decode_32k with its int8 cache), deepseek-v3
    (serve_batch through MLA and the 256-expert MoE, long_500k over the full
    latent cache, moe_ep == moe_dense) and grok-1 (serve_batch). No kernel
    of K1-K5 runs on this path. Returns the numbers."""
    import torch

    from repro_torch.kernels import embed

    t_phase = time.perf_counter()
    zero_launch_counts()
    k5 = embed.launches
    torch.cuda.empty_cache()
    out: dict = {"allocated_at_start": torch.cuda.memory_allocated()}

    qwen = lm_serve_case("qwen2.5-3b", device, consistency=True)
    model = qwen.pop("model")
    qwen["prefill_32k"] = lm_prefill_32k("qwen2.5-3b", model, device)
    qwen["decode_32k"] = lm_cell_decode("qwen2.5-3b", "decode_32k", model, device,
                                        LM_DECODE_BATCH["qwen2.5-3b"], 32768 - 1, seed=8)
    qwen["long_500k"] = lm_cell_decode("qwen2.5-3b", "long_500k", model, device, 1,
                                       524288 - 1, seed=9)
    del model
    torch.cuda.empty_cache()
    qwen["float32_card_vs_cpu"] = lm_float32_on_card(device)
    out["qwen2.5-3b"] = qwen

    for name in ("mistral-nemo-12b", "grok-1-314b"):
        res = lm_serve_case(name, device)
        del res["model"]
        torch.cuda.empty_cache()
        out[name] = res

    out["phi3-mini-3.8b"] = lm_int8_decode(device)

    ds = lm_serve_case("deepseek-v3-671b", device)
    model = ds.pop("model")
    ds["moe_on_card"] = lm_moe_on_card(model, lm_arch("deepseek-v3-671b").full, device)
    ds["long_500k"] = lm_cell_decode("deepseek-v3-671b", "long_500k", model, device, 1,
                                     524288 - 1, seed=10)
    del model
    torch.cuda.empty_cache()
    out["deepseek-v3-671b"] = ds

    launches = launch_counts()
    check(not any(launches.values()) and embed.launches == k5,
          f"phase 17's LM path launched a kernel of K1-K5: {launches}, K5 "
          f"{embed.launches - k5}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 18: LM training (loss_fn, the MTP loss, microbatching, the LM train
# kind, bfloat16 checkpoints) at published widths, bfloat16
# ---------------------------------------------------------------------------
# (a)-(c): the train kind at each config's published widths, depth and batch
# cut (global_batch, microbatches are the arch's unless said)
# (a) and (c) are cut in depth so that phase 19's per-microbatch gathers
# over gloo fit in the smoke's time
LM_TRAIN = {
    "a": dict(arch="qwen2.5-3b", cut=dict(n_layers=12), gb=2, steps=3),   # gb cut from 256
    "b": dict(arch="grok-1-314b", cut=dict(n_layers=1), gb=8, steps=2),   # 1 of 64 layers
    "c": dict(arch="deepseek-v3-671b", cut=dict(n_layers=1, n_dense_layers=1), gb=8, steps=2),
}
# (d): run_training at qwen2.5's widths cut to 2 layers, failures before steps 3 and 5
LM_LOOP = dict(arch="qwen2.5-3b", cut=dict(n_layers=2), gb=2, steps=6, ckpt_every=2,
               fails=(3, 5))
LM_CPU_SEQ = 128   # (a)'s card-vs-CPU check: qwen2.5's widths at 2 layers, float32, 1 x 128
# the loss on 128 tokens in float32: products of up to 11,008 terms in another order
# (sqrt(11008) * 2^-24 ~ 6e-6 each) through 2 layers and a 151,936-way logsumexp
LM_TRAIN_LOSS_RTOL = 1e-5
# the step's gradient (mu / (1 - b1), each leaf, normwise): as LM_F32_NORMWISE
LM_TRAIN_GRAD_NORMWISE = 1e-4
FINGERPRINT_CHUNK = 1 << 26


def fingerprint(tree) -> list:
    """(key, sum, position-weighted sum) of every tensor leaf's bits, as
    int64 sums mod 2^64: exact and independent of the summation order, so
    two states with equal fingerprints are bitwise equal but for a
    collision of both sums. One host read for the whole tree."""
    import torch

    from repro_torch.utils.tree import leaves_with_paths

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    keys, sums = [], []
    for key, t in leaves_with_paths(tree):
        bits = t.detach().reshape(-1).view(ints[t.element_size()])
        s1 = torch.zeros((), dtype=torch.int64, device=t.device)
        s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), FINGERPRINT_CHUNK):
            c = bits[i:i + FINGERPRINT_CHUNK].to(torch.int64)
            w = torch.arange(i, i + c.numel(), dtype=torch.int64, device=t.device) % 65521 + 1
            s1 += c.sum()
            s2 += (c * w).sum()
        keys.append(key)
        sums.append(torch.stack([s1, s2]))
    host = torch.stack(sums).cpu().tolist()
    return [(k, a, b) for k, (a, b) in zip(keys, host)]


class GradNorms:
    """Records the global gradient norm each optimizer update computes
    (``optim.optimizers.global_norm``, the clip's norm) while active, as
    the 0-d tensors it returns: no host read in the step."""

    def __enter__(self):
        from repro_torch.optim import optimizers

        self.mod, self.real, self.norms = optimizers, optimizers.global_norm, []

        def recorded(tree, layout=None):
            out = self.real(tree, layout)
            self.norms.append(out)
            return out

        optimizers.global_norm = recorded
        return self

    def __exit__(self, *exc):
        self.mod.global_norm = self.real


def lm_train_arch(name: str, cut: dict, gb: int, seq: int | None = None):
    """The arch with its FULL config cut in depth (``cut``) and train_4k's
    global batch (and, if given, its length) cut."""
    from repro_torch.configs import get_arch

    arch = get_arch(name)
    shapes = tuple(dataclasses.replace(s, dims=dict(s.dims, global_batch=gb,
                                                    **({"seq_len": seq} if seq else {})))
                   if s.name == "train_4k" else s for s in arch.shapes)
    return dataclasses.replace(arch, full=dataclasses.replace(arch.full, **cut), shapes=shapes)


def lm_train_step(arch, device):
    """``build_step(<arch>, "train_4k")`` with ``arch`` in place of the
    registry's."""
    from unittest import mock

    from repro_torch.launch import build_step, steps

    with mock.patch.object(steps, "get_arch", lambda _: arch):
        return build_step(arch.name, "train_4k", device=device)


def lm_train_batch(vocab: int, gb: int, seq: int, seed: int, device) -> dict:
    """Seeded uniform token rows of length seq + 1 on the device: tokens
    the first seq, labels the last seq."""
    import torch

    rows = torch.as_tensor(lm_prompts(gb, seq + 1, vocab, seed), device=device)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def lm_train_state(cfg, arch, device, seed: int):
    from repro_torch.launch import make_optimizer, train_state

    return train_state(lm_model(cfg, device, seed), make_optimizer(arch.optimizer))


def lm_train_case(label: str, spec: dict, device) -> dict:
    """One train-kind case: step 1 twice from the same seeded state (made
    anew for the second run, both fingerprinted: the state does not fit
    twice beside a step) with bitwise equal results, then the other steps;
    losses and gradient norms finite; each step after the warm first run
    timed (the median), the second run's host syncs counted (2 a MoE layer a
    microbatch under remat, 1 without, and no other), step 3 (or one more
    step) profiled on the device; peak memory."""
    import torch

    arch = lm_train_arch(spec["arch"], spec["cut"], spec["gb"])
    step = lm_train_step(arch, device)
    cfg = step.cfg
    seq = arch.shape("train_4k").dims["seq_len"]
    gb, m = spec["gb"], arch.microbatches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batches = [lm_train_batch(cfg.vocab, gb, seq, seed=20 + i, device=device)
               for i in range(spec["steps"])]
    out = dict(arch=arch.name, layers=cfg.n_layers, moe_layers=cfg.n_moe_layers, batch=gb,
               seq=seq, microbatches=m, accum=arch.grad_accum_dtype, optimizer=arch.optimizer,
               flash=(cfg.flash_q_chunk, cfg.flash_k_chunk), remat=cfg.remat)
    runs, walls, losses = [], [], []
    with GradNorms() as gn:
        for run in range(2):
            t0 = time.perf_counter()
            state = lm_train_state(cfg, arch, device, seed=0)
            torch.cuda.synchronize()
            out.setdefault("init_s", time.perf_counter() - t0)
            before = fingerprint(state)
            t0 = time.perf_counter()
            if run:
                out["host_syncs"], (p, o, loss) = count_syncs(
                    lambda: step.fn(state["params"], state["opt"], batches[0]))
            else:
                p, o, loss = step.fn(state["params"], state["opt"], batches[0])
            torch.cuda.synchronize()
            if run:
                walls.append(time.perf_counter() - t0)
            else:
                out["warm_s"] = time.perf_counter() - t0
            del state
            runs.append(dict(before=before, after=fingerprint({"params": p, "opt": o}),
                             loss=float(loss), grad_norm=float(gn.norms[-1])))
            if run == 0:
                del p, o
                torch.cuda.empty_cache()
        check(runs[0] == runs[1], f"{label} {arch.name}: two runs of step 1 from one seeded state "
              f"differ (loss {runs[0]['loss']} / {runs[1]['loss']}, gradient norm "
              f"{runs[0]['grad_norm']} / {runs[1]['grad_norm']}, leaves "
              f"{[a[0] for a, b in zip(runs[0]['after'], runs[1]['after']) if a != b][:5]})")
        losses.append(runs[1]["loss"])
        state = {"params": p, "opt": o}
        del p, o
        n_params = sum(t.numel() for t in state["params"].values())
        out.update(params=n_params, param_bytes=tree_bytes(state["params"]),
                   state_bytes=tree_bytes(state))
        for i in range(1, spec["steps"]):
            def one(i=i):
                return step.fn(state["params"], state["opt"], batches[i])
            if i == 2:   # step 3 ((a)): profiled, not timed
                kept = []
                out["profile"] = profile_call(lambda: kept.append(one()), warm=False, cpu=False)
                (p, o, loss), = kept
                del kept
            else:
                t0 = time.perf_counter()
                p, o, loss = one()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            state = {"params": p, "opt": o}
            del p, o
            losses.append(float(loss))
        norms = [float(x) for x in gn.norms]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{label} {arch.name}: losses {losses} or gradient norms {norms} not finite")
    out.update(losses=losses, grad_norms=norms, walls_s=walls,
               step_ms=statistics.median(walls) * 1e3)
    out["tokens_per_s"] = gb * seq / (out["step_ms"] / 1e3)
    out["model_flops"] = step.meta["model_flops"]
    out["tflops_per_s"] = step.meta["model_flops"] / (out["step_ms"] / 1e3) / 1e12
    syncs = out["host_syncs"]
    want = cfg.n_moe_layers * m * (2 if cfg.remat else 1)
    check(syncs == want, f"{label} {arch.name}: a step made {syncs} host syncs, not {want} (the "
          f"MoE layers' group sizes, read again by the remat)")
    if "profile" not in out:   # one more step, profiled
        out["profile"] = profile_call(
            lambda: step.fn(state["params"], state["opt"], batches[-1]), warm=False, cpu=False)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    prof = out["profile"]
    log(f"  ({label}) {arch.name}: {cfg.n_layers} layers ({cfg.n_moe_layers} MoE), {n_params} "
        f"parameters, {gb} x {seq} tokens, {m} microbatches accumulated in "
        f"{arch.grad_accum_dtype}, {arch.optimizer}, flash chunks {out['flash']}, remat "
        f"{cfg.remat}: two runs of step 1 "
        f"bitwise equal (fingerprints of every leaf, loss {runs[1]['loss']!r}, gradient norm "
        f"{runs[1]['grad_norm']!r}); losses {losses}, gradient norms {norms}; step "
        f"{out['step_ms']:.1f} ms median of {walls} s ({out['tokens_per_s']:.1f} tokens/s, "
        f"{out['tflops_per_s']:.1f} TFLOP/s of model flops); host syncs a step {syncs}; profiled "
        f"step: busy {prof.get('busy_ms', float('nan')):.1f} ms, idle "
        f"{100 * prof.get('idle_share', float('nan')):.1f} %, {prof.get('device_launches')} "
        f"launches, top {prof.get('top_ms')}; peak {out['peak_bytes']} bytes; state "
        f"{out['state_bytes']} bytes")
    out["state"] = state
    return out


def lm_update_ms(opt, state) -> dict:
    """The optimizer's update of ``state`` with gradients of the parameters'
    dtype: device time (CUDA events, 3 calls after a warm one) against its
    byte bound (the parameters and the optimizer state read and written
    once, the gradients read once, at 3.35 TB/s)."""
    import torch

    params, opt_state = state["params"], state["opt"]
    grads = {k: torch.full_like(v, 1e-3) for k, v in params.items()}
    ms = time_ms(lambda: opt.update(grads, opt_state, params), iters=3)
    n_bytes = 2 * tree_bytes(params) + tree_bytes(grads) + 2 * tree_bytes(opt_state)
    del grads
    return dict(ms=ms, bytes=n_bytes, bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3)


def lm_train_on_cpu(device) -> dict:
    """(a)'s step 1 at qwen2.5's widths cut to 2 layers, float32 (TF32 off),
    on 1 x LM_CPU_SEQ tokens, from the same weights (drawn on the CPU and
    copied), as test_lm_forward_on_card_matches_cpu holds the forward: the
    train kind's loss on the card against ``loss_fn`` on the CPU within rtol
    LM_TRAIN_LOSS_RTOL, and each leaf's ``mu`` (``(1 - b1)`` x the clipped
    gradient) against the CPU's gradient so scaled within
    LM_TRAIN_GRAD_NORMWISE normwise."""
    import torch

    from repro_torch.launch import make_optimizer
    from repro_torch.models import loss_fn

    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    arch = lm_train_arch("qwen2.5-3b", dict(n_layers=2, param_dtype=torch.float32,
                                            compute_dtype=torch.float32), 1, LM_CPU_SEQ)
    cfg = arch.full
    model = lm_model(cfg, "cpu", seed=4)
    batch = lm_train_batch(cfg.vocab, 1, LM_CPU_SEQ, seed=4, device="cpu")
    leaves = {k: v.detach().requires_grad_() for k, v in model.named_parameters()}
    loss_cpu = loss_fn(model, batch["tokens"], batch["labels"], cfg, leaves)
    g_cpu = dict(zip(leaves, torch.autograd.grad(loss_cpu, list(leaves.values()))))
    cpu_s = time.perf_counter() - t0
    card = {k: v.detach().to(device) for k, v in leaves.items()}
    del leaves, model
    opt = make_optimizer(arch.optimizer)
    _, o_card, loss_card = lm_train_step(arch, device).fn(
        card, opt.init(card), {k: v.to(device) for k, v in batch.items()})
    a = ADAMW_STEP1
    norm = float(torch.sqrt(sum(g.square().sum() for g in g_cpu.values())))
    clip = min(1.0, a["grad_clip"] / norm)
    rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    errs = {k: normwise(o_card["mu"][k], (1 - a["b1"]) * clip * g) for k, g in g_cpu.items()}
    worst = max(errs, key=errs.get)
    check(rel <= LM_TRAIN_LOSS_RTOL, f"(a) at 2 layers, float32: the card's step-1 loss "
          f"{float(loss_card)!r} misses the CPU's {float(loss_cpu)!r} by {rel}")
    check(errs[worst] <= LM_TRAIN_GRAD_NORMWISE, f"(a) at 2 layers, float32: the card's "
          f"gradient of {worst} misses the CPU's by {errs[worst]} normwise")
    del card, o_card, g_cpu
    torch.cuda.empty_cache()
    out = dict(loss_card=float(loss_card), loss_cpu=float(loss_cpu), loss_rel=rel,
               worst_grad=(worst, errs[worst]), wall_s=time.perf_counter() - t0, cpu_s=cpu_s)
    log(f"  (a) card vs CPU, qwen2.5's widths at 2 layers, float32, 1 x {LM_CPU_SEQ} tokens: "
        f"step-1 loss {out['loss_card']!r} vs {out['loss_cpu']!r} (rel {rel:.3g} <= "
        f"{LM_TRAIN_LOSS_RTOL}), worst gradient leaf {worst} {errs[worst]:.3g} normwise (<= "
        f"{LM_TRAIN_GRAD_NORMWISE}); {out['wall_s']:.1f} s ({cpu_s:.1f} s on the CPU)")
    return out


def lm_train_loop(device) -> dict:
    """(d): run_training of the train kind at qwen2.5's widths cut to 2
    layers, bfloat16, AdamW: an uninterrupted run of LM_LOOP's steps, then
    one with async checkpoints every ckpt_every steps in JAX's layout
    (``LM_STATE_LAYOUT``, keep=1) and failures before steps ``fails``:
    losses and every final leaf bitwise equal, and the newest checkpoint
    restored onto the card bitwise equal to the final state (its bfloat16
    parameters included). Snapshot, write and restore seconds."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import LoopConfig, make_optimizer, restore_elastic, run_training
    from repro_torch.models import LM_STATE_LAYOUT

    spec = LM_LOOP
    arch = lm_train_arch(spec["arch"], spec["cut"], spec["gb"])
    step = lm_train_step(arch, device)
    cfg = step.cfg
    seq = arch.shape("train_4k").dims["seq_len"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def init_state():
        return lm_train_state(cfg, arch, device, seed=7)

    def step_fn(state, batch):
        p, o, loss = step.fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, loss

    def data(start):
        i = start
        while True:
            yield lm_train_batch(cfg.vocab, spec["gb"], seq, seed=100 + i, device=device)
            i += 1

    loop = LoopConfig(total_steps=spec["steps"], ckpt_every=spec["ckpt_every"])
    t0 = time.perf_counter()
    ref = run_training(step_fn, init_state, data, None, loop)
    out = dict(steps=spec["steps"], ckpt_every=spec["ckpt_every"], fails=spec["fails"],
               uninterrupted_s=time.perf_counter() - t0, losses=ref.losses)
    n_bytes = tree_bytes(ref.final_state)
    tmp_root = tempfile.gettempdir()
    free = shutil.disk_usage(tmp_root).free
    out.update(checkpoint_bytes=n_bytes, free_bytes=free)
    check(free >= 2 * n_bytes, f"(d): {free} bytes free under {tmp_root}: too small for two "
          f"checkpoints of {n_bytes} bytes")

    class TimedCheckpoints(CheckpointManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.times = dict(snapshot_s=[], write_s=[], restore_s=[])

        def save(self, step_, state, blocking=False):
            self.wait()  # the snapshot below is timed alone
            t0_ = time.perf_counter()
            host = super().save(step_, state, blocking)
            self.times["snapshot_s"].append(time.perf_counter() - t0_)
            return host

        def _write(self, step_, host_state):
            t0_ = time.perf_counter()
            super()._write(step_, host_state)
            self.times["write_s"].append(time.perf_counter() - t0_)

        def restore(self, target, step=None):
            t0_ = time.perf_counter()
            res_ = super().restore(target, step)
            self.times["restore_s"].append(time.perf_counter() - t0_)
            return res_

    fails = set(spec["fails"])

    def inject(s):
        if s in fails:
            fails.discard(s)
            raise RuntimeError(f"simulated worker loss at step {s}")

    ckpt_dir = tempfile.mkdtemp(prefix="smoke_lm_ckpt_")
    try:
        ckpt = TimedCheckpoints(ckpt_dir, keep=1, async_save=True, layout=LM_STATE_LAYOUT)
        t0 = time.perf_counter()
        res = run_training(step_fn, init_state, data, ckpt, loop, failure_injector=inject)
        out["failure_run_s"] = time.perf_counter() - t0
        with open(os.path.join(ckpt_dir, f"step_{spec['steps']}", "manifest.json")) as f:
            keys = json.load(f)["leaves"]
        last, restored = restore_elastic(ckpt, res.final_state, device=device)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    a, b = spec["fails"]
    e = spec["ckpt_every"]
    want = ref.losses[:a] + ref.losses[a - a % e:b] + ref.losses[b - b % e:]
    check(res.restarts == 2 and res.losses == want,
          f"(d): restarts {res.restarts}, losses {res.losses}, not {want}")
    check(same_tensors(res.final_state, ref.final_state),
          "(d): the run with two failures ends with other tensors than the uninterrupted run")
    check(last == spec["steps"] and same_tensors(restored, ref.final_state),
          "(d): the newest checkpoint restored onto the card is not the final state bit for bit")
    check("params/dense_blocks/attn/wq" in keys and "opt/nu/embed" in keys,
          f"(d): the checkpoint's keys are not JAX's: {sorted(keys)[:4]}")
    out.update({k: v for k, v in ckpt.times.items()})
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["update"] = lm_update_ms(make_optimizer(arch.optimizer), ref.final_state)
    del ref, res, restored
    torch.cuda.empty_cache()
    log(f"  (d) run_training at qwen2.5's widths, 2 layers, bf16, AdamW, {spec['steps']} steps of "
        f"{spec['gb']} x {seq}: failures before steps {spec['fails']} with async checkpoints "
        f"every {e} steps in JAX's layout ({n_bytes} bytes each, keep=1): restarts 2, losses "
        f"and every final leaf bitwise equal to the uninterrupted run, the newest checkpoint "
        f"restored onto the card bitwise (bf16 parameters included); runs "
        f"{out['uninterrupted_s']:.1f} / {out['failure_run_s']:.1f} s; snapshots "
        f"{ckpt.times['snapshot_s']} s, writes {ckpt.times['write_s']} s, restores "
        f"{ckpt.times['restore_s']} s; AdamW update {out['update']['ms']:.2f} ms against a "
        f"{out['update']['bound_ms']:.2f} ms bound ({out['update']['bytes']} bytes at 3.35 TB/s); "
        f"peak {out['peak_bytes']} bytes")
    return out


def phase_lm_train(device: str) -> dict:
    """Phase 18: LM training at published widths in bfloat16 (random seeded
    weights, seeded uniform tokens): (a) qwen2.5-3b cut to 12 of its 36
    layers, AdamW, with the card-vs-CPU check at 2 layers in float32; (b)
    grok-1 cut to 1 layer, 8 microbatches in bf16, Adafactor: the MoE
    backward; (c) deepseek-v3 cut to its first (dense) layer with its MTP
    block: MLA's backward
    and the MTP loss, Adafactor, 8 microbatches; (d) the fault-tolerant loop
    with bfloat16 checkpoints in JAX's layout. No kernel of K1-K5 runs on
    this path. Returns the numbers."""
    import torch

    from repro_torch.kernels import embed
    from repro_torch.launch import make_optimizer

    t_phase = time.perf_counter()
    zero_launch_counts()
    k5 = embed.launches
    torch.set_float32_matmul_precision("highest")
    out: dict = {}
    for label, spec in LM_TRAIN.items():
        res = lm_train_case(label, spec, device)
        state = res.pop("state")
        if label == "c":
            res["update"] = lm_update_ms(make_optimizer(res["optimizer"]), state)
            log(f"  (c) Adafactor update of {res['params']} parameters: "
                f"{res['update']['ms']:.2f} ms against a {res['update']['bound_ms']:.2f} ms "
                f"bound ({res['update']['bytes']} bytes at 3.35 TB/s)")
        del state
        torch.cuda.empty_cache()
        out[label] = res
        if label == "a":
            out["a_card_vs_cpu"] = lm_train_on_cpu(device)
    out["d"] = lm_train_loop(device)
    launches = launch_counts()
    check(not any(launches.values()) and embed.launches == k5,
          f"phase 18's LM training launched a kernel of K1-K5: {launches}, K5 "
          f"{embed.launches - k5}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 19, build_step over a mesh: the LM kinds' sharded layouts (tp_sp with
# FSDP, zero3, prefill's and decode's caches) and the GNN train kind with K1
# on each rank; world 1 in the smoke's process, then two gloo ranks on the card
# ---------------------------------------------------------------------------
# the train kind in float32 at published widths, depth and batch cut (the
# arch's microbatches, optimizer and layout: mistral-nemo tp_sp with FSDP and
# 4 microbatches, qwen2.5 zero3 where the batch covers the mesh)
STEP_MESH_TRAIN = {
    "mistral": dict(arch="mistral-nemo-12b", cut=dict(n_layers=2), gb=8, seq=128,
                    meshes=((1, 2), (2, 1)), steps=((1, 2),)),
    "qwen": dict(arch="qwen2.5-3b", cut=dict(n_layers=2), gb=2, seq=128, meshes=((2, 1),),
                 steps=((2, 1),)),
    # qwen2.5's 2 key heads do not split over 4: each rank its sequence block
    # of every head (the reference's act4 under sp), 2,048 tokens the flash path
    "qwen-sp": dict(arch="qwen2.5-3b", cut=dict(n_layers=2), gb=2, seq=2048,
                    meshes=((1, 4),), steps=()),
}
STEP_MESH_WORLDS = {2: ((1, 2), (2, 1)), 4: ((1, 4),)}   # the meshes of each gloo world
# each train case's peak a rank (max_memory_allocated) where the train kind
# gathered every weight once a step and accumulated gathered-size gradients,
# read on one NVIDIA H100 80GB HBM3 at 700 W: logged beside today's
STEP_MESH_PEAK_ONCE_A_STEP = {"mistral/1x2": 27834127360, "mistral/2x1": 31147111936,
                              "qwen/2x1": 12310534144, "qwen-sp/1x4": 3798316544}
# a rank's attention FLOPs against world 1's over the mesh's size: every rank
# computes its share of the same score and value products
STEP_MESH_ATTN_RTOL = 0.02
# ``steps``: the meshes that also run the whole train step twice over (the
# update of the gradient, then ``fn`` from the same state, bitwise). Over (2,
# 1) mistral-nemo runs its gradient once: a rank holds its 5.1 GB of
# parameter slices, an accumulator of them and one microbatch's gradient of
# them (5.1 GB each; a block's 1.1 GB of gathered weights and their gradient
# come and go), so AdamW's 10.2 GB of moments would fit, but each of its 4
# microbatches gathers every block twice (forward, recompute) and sums their
# gradients and the tables' through gloo: a second gradient would add its
# wall again.
# prefill then teacher-forced decode in the arch's bfloat16 over (1, 2), the
# logits against world 1 within LM_BF16_NORMWISE: the two round each layer's
# products differently (the ranks' halves of every product, their sums in
# float32), phase 17's random walk of bfloat16 roundings; 1.0 % and 1.4 % were
# read at qwen2.5's 2 layers, measured on one H100
STEP_MESH_SERVE = {
    "qwen": dict(arch="qwen2.5-3b", cut=dict(n_layers=2), batch=2, prompt=512, new=8),
    "deepseek": dict(arch="deepseek-v3-671b", cut=LM_CUTS["deepseek-v3-671b"], batch=2,
                     prompt=512, new=8),
}
STEP_MESH_GNN = ((2, 1), (1, 2))   # gcn-cora at ogb_products' size, K1 on each rank
STEP_MESH_SEED = 19
STEP_MESH_K1 = 3   # K1 launches of a GCN step a rank: the degrees and two layers' sums
PRODUCTS_LANES: dict = {}   # phase 13's dst-sorted ogb_products lanes, for phase 19


def step_mesh_train_arch(spec: dict):
    """The arch of a train case: its FULL config cut and in float32."""
    import torch

    return lm_train_arch(spec["arch"], dict(spec["cut"], param_dtype=torch.float32,
                                            compute_dtype=torch.float32),
                         spec["gb"], spec["seq"])


def step_mesh_build(arch, shape: str, device=None, mesh=None):
    """``build_step`` with ``arch`` in place of the registry's."""
    from unittest import mock

    from repro_torch.launch import build_step, steps

    with mock.patch.object(steps, "get_arch", lambda _: arch):
        return build_step(arch.name, shape, device=device, mesh=mesh)


def counted_attention(fn):
    """(``fn()``, the attention's forward FLOPs in every call of
    ``transformer._flash_or_plain`` during it, once more in a remat's
    recompute): the scores and the weighted sum of q ``[B, Sq, H, hd]``
    against every key, ``2 B H Sq Sk (hd + dv)``, what ``FlopCounterMode``
    counts for both paths (the flash path runs every k-block). Read from the
    shapes: the counter itself costs about 0.1 s an entry."""
    from unittest import mock

    from repro_torch.models import transformer

    inner, total = transformer._flash_or_plain, [0]

    def counted(q, k, v, *args, **kwargs):
        b, sq, h, hd = q.shape
        total[0] += 2 * b * h * sq * k.shape[1] * (hd + v.shape[-1])
        return inner(q, k, v, *args, **kwargs)

    with mock.patch.object(transformer, "_flash_or_plain", counted):
        return fn(), total[0]


def step_mesh_serve_arch(spec: dict):
    from repro_torch.configs import get_arch

    arch = get_arch(spec["arch"])
    return dataclasses.replace(arch, full=dataclasses.replace(arch.full, **spec["cut"]))


def products_lanes() -> dict:
    """ogb_products' lanes sorted by dst (phase 13's, or built here)."""
    if not PRODUCTS_LANES:
        from repro_torch.graphs import Graph
        from repro_torch.graphs.partition import partition_by_dst_block

        rng = np.random.default_rng(GNN_PRODUCTS["seed"])
        g = Graph.from_edges(rng.integers(0, GNN_PRODUCTS["n"], (GNN_PRODUCTS["pairs"], 2)),
                             GNN_PRODUCTS["n"])
        src, dst, _ = partition_by_dst_block(g, 2)
        PRODUCTS_LANES.update(src=src, dst=dst, n=g.n_nodes)
    return PRODUCTS_LANES


def block_lanes(src, dst, n_rows: int, shape) -> tuple[np.ndarray, np.ndarray]:
    """dst-sorted lanes as the reference's hint takes them over ``shape``:
    ``shape[0]`` dst blocks of ``n_rows / shape[0]`` rows, each padded with
    the sentinel ``n_rows`` to the same multiple of ``shape[1]`` lanes."""
    blocks, sub = shape
    bounds = np.searchsorted(dst, np.arange(0, n_rows + 1, n_rows // blocks))
    per = int(-(-int(np.diff(bounds).max()) // sub) * sub)
    s = np.full(per * blocks, n_rows, np.int32)
    d = np.full(per * blocks, n_rows, np.int32)
    for b in range(blocks):
        lo, hi = bounds[b], bounds[b + 1]
        s[b * per:b * per + hi - lo] = src[lo:hi]
        d[b * per:b * per + hi - lo] = dst[lo:hi]
    return s, d


def step_mesh_gnn_batch(tmp: Path) -> dict:
    """gcn-cora's ogb_products batch (seeded node features, labels, masks;
    the node rows padded as the step pads them) and each mesh's lanes, as
    npy files in ``tmp`` for the ranks; returns (2, 1)'s batch."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import _gnn_dims

    lanes = products_lanes()
    n_rows = _gnn_dims(get_arch("gcn-cora").shape("ogb_products"), 1)[0]
    n = lanes["n"]
    rng = np.random.default_rng(STEP_MESH_SEED)
    real = np.arange(n_rows) < n
    nodes = {"node_feat": rng.standard_normal((n_rows, 100), dtype=np.float32),
             "labels": rng.integers(0, 7, n_rows).astype(np.int32),
             "label_mask": real & (rng.random(n_rows) < 0.5),
             "node_mask": real, "graph_id": np.zeros(n_rows, np.int32)}
    for k, v in nodes.items():
        np.save(tmp / f"gnn_{k}.npy", v)
    for shape in STEP_MESH_GNN:
        s, d = block_lanes(lanes["src"], lanes["dst"], n_rows, shape)
        np.save(tmp / f"gnn_src_{shape[0]}x{shape[1]}.npy", s)
        np.save(tmp / f"gnn_dst_{shape[0]}x{shape[1]}.npy", d)
    return step_mesh_gnn_load(tmp, STEP_MESH_GNN[0])


def step_mesh_gnn_load(tmp: Path, shape) -> dict:
    """The batch of ``shape`` (read-only memory maps: a rank copies its share)."""
    out = {k: np.load(tmp / f"gnn_{k}.npy", mmap_mode="r")
           for k in ("node_feat", "labels", "label_mask", "node_mask", "graph_id")}
    for k in ("src", "dst"):
        out[k] = np.load(tmp / f"gnn_{k}_{shape[0]}x{shape[1]}.npy", mmap_mode="r")
    return out


def step_mesh_world1(device, tmp: Path) -> dict:
    """World 1 of phase 19: each train case's loss and gradients (the
    gradients to ``tmp`` for the ranks), each serving case's prefill logits
    and cache and its greedy decode, and the GCN step at ogb_products' size
    on the plain path; every card tensor freed."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import train_state
    from repro_torch.models import init_cache

    out = {}
    for label, spec in STEP_MESH_TRAIN.items():
        arch = step_mesh_train_arch(spec)
        step = step_mesh_build(arch, "train_4k", device=device)
        torch.cuda.reset_peak_memory_stats()
        model = lm_model(step.cfg, device, STEP_MESH_SEED)
        params = {k: v.detach() for k, v in model.named_parameters()}
        batch = lm_train_batch(step.cfg.vocab, spec["gb"], spec["seq"], STEP_MESH_SEED, device)
        t0 = time.perf_counter()
        (loss, grads), attn = counted_attention(lambda: step.grad(params, batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (tmp / label).mkdir()
        for k, g in grads.items():
            np.save(tmp / label / f"{k}.npy", g.float().cpu().numpy())
        out[label] = dict(loss=float(loss), wall_s=wall,
                          peak_bytes=torch.cuda.max_memory_allocated(),
                          param_bytes=tree_bytes(params), attn_flops=attn)
        del model, params, grads, loss
        torch.cuda.empty_cache()
    for label, spec in STEP_MESH_SERVE.items():
        arch = step_mesh_serve_arch(spec)
        pre = step_mesh_build(arch, "prefill_32k", device=device)
        dec = step_mesh_build(arch, "decode_32k", device=device)
        torch.cuda.reset_peak_memory_stats()
        model = lm_model(pre.cfg, device, STEP_MESH_SEED)
        prompts = lm_prompts(spec["batch"], spec["prompt"], pre.cfg.vocab, STEP_MESH_SEED)
        t0 = time.perf_counter()
        logits, cache = pre.fn(model, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = init_cache(dec.cfg, spec["batch"], spec["prompt"] + spec["new"], device=device)
        for k, v in cache.items():
            c[k][:, :, :spec["prompt"]] = v
        toks, steps = [logits.argmax(-1)], []
        for t in range(spec["new"]):
            lg, c = dec.fn(model, c, toks[-1], spec["prompt"] + t)
            steps.append(lg.float().cpu())
            toks.append(lg.argmax(-1))
        out[label + "-serve"] = dict(prefill=logits.float().cpu(), decode=torch.stack(steps),
                                     tokens=torch.stack(toks).cpu(), prefill_wall_s=wall,
                                     peak_bytes=torch.cuda.max_memory_allocated())
        np.save(tmp / f"{label}-tokens.npy", out[label + "-serve"]["tokens"].numpy())
        del model, cache, c, logits, lg
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = step_mesh_gnn_batch(tmp)
    host_s = time.perf_counter() - t0
    gcn = get_arch("gcn-cora")
    step = step_mesh_build(gcn, "ogb_products", device=device)
    model = gnn_model("gcn-cora", dataclasses.replace(gcn.full, d_feat=100), device,
                      STEP_MESH_SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = step.grad(train_state(model, step.opt)["params"], batch)
    torch.cuda.synchronize()
    out["gcn"] = dict(loss=float(loss), grads={k: g.float().cpu() for k, g in grads.items()},
                      wall_s=time.perf_counter() - t0, host_batch_s=host_s,
                      peak_bytes=torch.cuda.max_memory_allocated())
    del model, grads, loss, batch
    torch.cuda.empty_cache()
    return out


def _grad_stats(grads: dict, specs: dict, ref_dir: Path, mesh) -> dict:
    """Per leaf, (sum of squared differences, sum of squares of the
    reference) over this rank's slice of world 1's gradient, float64."""
    import torch

    from repro_torch.models.shard import local_slice, spec_axes

    out = {}
    for k, g in grads.items():
        ref = torch.from_numpy(np.ascontiguousarray(local_slice(
            np.load(ref_dir / f"{k}.npy", mmap_mode="r"), specs[k], mesh))).to(g.device)
        d = (g.float() - ref).double()
        out[k] = (float(d.square().sum()), float(ref.double().square().sum()),
                  bool(spec_axes(specs[k])))
        del ref, d
    return out


def _step_mesh_rank(rank: int, world: int, init: str, data: str, out: str,
                    device: str = "cuda") -> None:
    """One rank of phase 19's world 2 or 4 (gloo, every rank on cuda:0):
    the train cases over the world's meshes (loss, gradient statistics
    against world 1's, attention FLOPs, the step's repeatability); in world
    2 also the serving cases over (1, 2) (prefill, then decode
    teacher-forced by world 1's greedy tokens) and the GCN step over (2, 1)
    and (1, 2) with K1 on; to ``out``."""
    import os

    # the ranks' float32 states share the card: allocate in growable segments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.kernels import segsum
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.shard import gather, local_slice

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        segsum.load_library()  # built by the parent's phase 1: a load, not a build
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0") if on_card else torch.device(device)
    tmp = Path(data)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    res = {}
    try:
        meshes = {s: distributed.make_mesh(s, MESH_AXES, device=dev)
                  for s in STEP_MESH_WORLDS[world]}

        def draw(cfg, mesh, specs):
            # world 1's values: every whole leaf drawn in turn, this rank's slice kept
            gen = torch.Generator(device=dev).manual_seed(STEP_MESH_SEED)
            return init_params(cfg, generator=gen, mesh=mesh, specs=specs)

        for label, spec in STEP_MESH_TRAIN.items():
            arch = step_mesh_train_arch(spec)
            for shape in (s for s in spec["meshes"] if s in meshes):
                mesh, key = meshes[shape], f"{label}/{shape[0]}x{shape[1]}"
                step = step_mesh_build(arch, "train_4k", mesh=mesh)
                layout = (mesh, step.specs)
                params = {k: v.detach() for k, v in draw(step.cfg, mesh, step.specs)
                          .named_parameters()}
                batch = lm_train_batch(step.cfg.vocab, spec["gb"], spec["seq"], STEP_MESH_SEED,
                                       dev)
                torch.cuda.reset_peak_memory_stats() if on_card else None
                t0 = time.perf_counter()
                (loss, grads), attn = counted_attention(lambda: step.grad(params, batch))
                torch.cuda.synchronize() if on_card else None
                res[f"{key}/wall_s"] = np.array(time.perf_counter() - t0)
                res[f"{key}/attn_flops"] = np.array(attn)
                res[f"{key}/heads_split"] = np.array(
                    step.ctx.act4(step.cfg.n_heads, step.cfg.n_kv_heads)[2] is not None)
                res[f"{key}/loss"] = np.array(float(loss))
                res[f"{key}/stats"] = np.array(json.dumps(_grad_stats(grads, step.specs,
                                                                      tmp / label, mesh)))
                res[f"{key}/layout"] = np.array("zero3" if step.ctx.tp is None else "tp_sp")
                res[f"{key}/finite"] = np.array(True)
                res[f"{key}/bitwise"] = np.array(-1)   # not run
                if shape in spec["steps"]:
                    # the whole train kind twice over: the update of this
                    # gradient, then the step from the same state, bitwise
                    state0 = step.opt.init(params, layout)
                    want = fingerprint(step.opt.update(grads, state0, params, layout)[0])
                    del grads
                    new_p, new_o, loss2 = step.fn(params, state0, batch)
                    res[f"{key}/bitwise"] = np.array(int(fingerprint(new_p) == want
                                                         and bool(torch.equal(loss2, loss))))
                    res[f"{key}/finite"] = np.array(all(bool(torch.isfinite(v).all())
                                                        for v in new_p.values()))
                    del state0, new_p, new_o, loss2
                else:
                    del grads
                res[f"{key}/peak_bytes"] = np.array(torch.cuda.max_memory_allocated()
                                                    if on_card else 0)
                res[f"{key}/shard_bytes"] = np.array(tree_bytes(params))
                del params, loss, batch
                torch.cuda.empty_cache() if on_card else None
        if world != 2:   # the serving cases and the GCN step run in world 2
            np.savez(out, **res)
            return

        mesh = meshes[(1, 2)]
        for label, spec in STEP_MESH_SERVE.items():
            arch = step_mesh_serve_arch(spec)
            pre = step_mesh_build(arch, "prefill_32k", mesh=mesh)
            dec = step_mesh_build(arch, "decode_32k", mesh=mesh)
            torch.cuda.reset_peak_memory_stats() if on_card else None
            model = draw(pre.cfg, mesh, pre.specs)
            prompts = lm_prompts(spec["batch"], spec["prompt"], pre.cfg.vocab, STEP_MESH_SEED)
            t0 = time.perf_counter()
            logits, cache = pre.fn(model, prompts)
            torch.cuda.synchronize() if on_card else None
            res[f"{label}/prefill_wall_s"] = np.array(time.perf_counter() - t0)
            again, _ = pre.fn(model, prompts)
            res[f"{label}/bitwise"] = np.array(bool(torch.equal(again, logits)))
            res[f"{label}/prefill"] = logits.float().cpu().numpy()
            # prefill's layout (the sequence over "model") into decode's
            c = init_cache(dec.cfg, spec["batch"], spec["prompt"] + spec["new"], mesh=mesh,
                           specs=dec.cache_specs)
            with torch.no_grad():
                for k, v in cache.items():
                    whole = gather(v, pre.cache_specs[k], mesh)
                    c[k][:, :, :spec["prompt"]] = local_slice(whole, dec.cache_specs[k], mesh)
            del cache, again
            toks = torch.as_tensor(np.load(tmp / f"{label}-tokens.npy"), device=dev)
            steps = []
            for t in range(spec["new"]):
                lg, c = dec.fn(model, c, toks[t], spec["prompt"] + t)
                steps.append(lg.float().cpu().numpy())
            res[f"{label}/decode"] = np.stack(steps)
            res[f"{label}/peak_bytes"] = np.array(torch.cuda.max_memory_allocated()
                                                  if on_card else 0)
            del model, c, logits, lg
            torch.cuda.empty_cache() if on_card else None

        from repro_torch.configs import get_arch
        from repro_torch.launch import train_state

        # the gathers' backward (index_add_) in its sorted, repeatable form
        torch.use_deterministic_algorithms(True, warn_only=True)
        for shape in STEP_MESH_GNN:
            mesh, key = meshes[shape], f"gcn/{shape[0]}x{shape[1]}"
            step = step_mesh_build(get_arch("gcn-cora"), "ogb_products", mesh=mesh)
            model = gnn_model("gcn-cora", dataclasses.replace(get_arch("gcn-cora").full,
                                                              d_feat=100), dev, STEP_MESH_SEED)
            params = train_state(model, step.opt)["params"]
            batch = step_mesh_gnn_load(tmp, shape)
            torch.cuda.reset_peak_memory_stats() if on_card else None
            k1 = segsum.launches
            t0 = time.perf_counter()
            loss, grads = step.grad(params, batch)
            torch.cuda.synchronize() if on_card else None
            res[f"{key}/wall_s"] = np.array(time.perf_counter() - t0)
            res[f"{key}/k1_launches"] = np.array(segsum.launches - k1)
            again = step.grad(params, batch)
            res[f"{key}/bitwise"] = np.array(bool(torch.equal(again[0], loss) and all(
                torch.equal(again[1][k], g) for k, g in grads.items())))
            res[f"{key}/loss"] = np.array(float(loss))
            res.update({f"{key}/g/{k}": g.float().cpu().numpy() for k, g in grads.items()})
            res[f"{key}/peak_bytes"] = np.array(torch.cuda.max_memory_allocated()
                                                if on_card else 0)
            del model, params, grads, again, loss
            torch.cuda.empty_cache() if on_card else None
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def spawn_step_mesh_ranks(world: int, tmp: Path, device: str) -> tuple[list[dict], float]:
    """``world`` gloo ranks of ``_step_mesh_rank`` (every one on cuda:0),
    each killed past ``SPAWN_TIMEOUT_S``: (their outputs, the seconds)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp / f'rendezvous{world}'}"
    outs = [tmp / f"world{world}_rank{r}.npz" for r in range(world)]
    procs = [ctx.Process(target=_step_mesh_rank,
                         args=(r, world, init, str(tmp), str(outs[r]), device))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    check(not hung, f"phase 19: {len(hung)} of world {world}'s ranks still running after "
          f"{SPAWN_TIMEOUT_S} s")
    check(all(p.exitcode == 0 for p in procs),
          f"phase 19: world {world}'s rank exit codes {[p.exitcode for p in procs]}")
    return [dict(np.load(o)) for o in outs], time.perf_counter() - t0


def step_mesh_train_results(w1: dict, worlds: dict, card: str) -> dict:
    """Each train case over each of its meshes, the ranks of its world
    (``worlds[size]``) held to world 1's ``w1``: loss, repeatability,
    finite parameters, attention FLOPs, gradients; its numbers by key."""
    res = {}
    for label, spec in STEP_MESH_TRAIN.items():
        want = w1[label]
        for shape in spec["meshes"]:
            key = f"{label}/{shape[0]}x{shape[1]}"
            size = shape[0] * shape[1]
            group = worlds[size]
            attn = [int(rk[f"{key}/attn_flops"]) for rk in group]
            for r, rk in enumerate(group):
                loss = float(rk[f"{key}/loss"])
                check(abs(loss - want["loss"]) <= LM_TRAIN_LOSS_RTOL * abs(want["loss"]),
                      f"{key} rank {r}: loss {loss} vs world 1's {want['loss']}")
                check(int(rk[f"{key}/bitwise"]) != 0, f"{key} rank {r}: the step is not "
                      f"repeatable")
                check(bool(rk[f"{key}/finite"]), f"{key} rank {r}: non-finite parameters")
                check(abs(attn[r] * size / want["attn_flops"] - 1) <= STEP_MESH_ATTN_RTOL,
                      f"{key} rank {r}: {attn[r]} attention FLOPs, world 1's "
                      f"{want['attn_flops']} over {size} ranks")
            if label == "qwen-sp":
                check(not any(bool(rk[f"{key}/heads_split"]) for rk in group),
                      f"{key}: the heads split over 'model'; the case is for a layout "
                      f"whose key heads do not")
            errs = _split_stats([json.loads(str(rk[f"{key}/stats"])) for rk in group])
            worst = max(errs, key=errs.get)
            check(errs[worst] <= LM_TRAIN_GRAD_NORMWISE,
                  f"{key}: gradient {worst} {errs[worst]} from world 1 (normwise, <= "
                  f"{LM_TRAIN_GRAD_NORMWISE})")
            res[key] = dict(layout=str(group[0][f"{key}/layout"]),
                            loss=[float(rk[f"{key}/loss"]) for rk in group],
                            world1_loss=want["loss"], worst_grad=(worst, errs[worst]),
                            attn_flops=attn, world1_attn_flops=want["attn_flops"],
                            wall_s=[float(rk[f"{key}/wall_s"]) for rk in group],
                            world1_wall_s=want["wall_s"],
                            peak_bytes=[int(rk[f"{key}/peak_bytes"]) for rk in group],
                            world1_peak_bytes=want["peak_bytes"],
                            shard_bytes=[int(rk[f"{key}/shard_bytes"]) for rk in group],
                            param_bytes=want["param_bytes"])
            log(f"  phase 19 {key} ({res[key]['layout']}, {spec['arch']} at "
                f"{spec['cut']['n_layers']} layers, float32, {spec['gb']} x {spec['seq']} tokens): "
                f"loss by rank {res[key]['loss']} vs world 1 {want['loss']}; worst gradient leaf "
                f"{worst} {errs[worst]:.3e} normwise; "
                f"{'the step bitwise repeatable' if shape in spec['steps'] else 'no step'}; "
                f"attention FLOPs (forward) by rank {attn} vs world 1's over {size} "
                f"{want['attn_flops'] / size:.6g}; "
                f"gradient wall by rank {res[key]['wall_s']} s (world 1 {want['wall_s']:.3f} s); "
                f"{res[key]['shard_bytes']} bytes of parameters a rank of {want['param_bytes']}; "
                f"peak by rank {res[key]['peak_bytes']} bytes (world 1 {want['peak_bytes']}; "
                f"every weight gathered once a step: {STEP_MESH_PEAK_ONCE_A_STEP.get(key)}) "
                f"({card})")
    return res


def phase_step_mesh(device: str) -> dict:
    """Phase 19: world 1 here (``step_mesh_world1``), then two gloo ranks on
    the card (``_step_mesh_rank``), then four, each case held to world 1:
    the float32 loss (rtol ``LM_TRAIN_LOSS_RTOL``) and each gradient leaf
    put together (normwise ``LM_TRAIN_GRAD_NORMWISE``), each rank's
    attention FLOPs (world 1's over the mesh's size, rtol
    ``STEP_MESH_ATTN_RTOL``), the bfloat16 logits (normwise
    ``LM_BF16_NORMWISE``), greedy tokens, bitwise repeatability; K1 on each
    rank in the GCN step. A rank that fails, or a spawn past
    ``SPAWN_TIMEOUT_S``, fails the smoke. Returns the phase's numbers,
    ``k1_launches`` K1's launches on both ranks."""
    import gc
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    torch.set_float32_matmul_precision("highest")
    tmp = Path(tempfile.mkdtemp(prefix="smoke_step_mesh_"))
    try:
        t0 = time.perf_counter()
        w1 = step_mesh_world1(device, tmp)
        world1_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  phase 19 world 1 took {world1_s:.3f} s; before the ranks this process holds "
            f"{torch.cuda.memory_allocated()} bytes ({torch.cuda.memory_reserved()} reserved)")
        worlds, spawn_s = {}, {}
        for world in STEP_MESH_WORLDS:
            worlds[world], spawn_s[world] = spawn_step_mesh_ranks(world, tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = worlds[2]
    card = card_line()
    res = dict(card=card, world1_s=world1_s, spawn_s=spawn_s)
    res.update(step_mesh_train_results(w1, worlds, card))
    for label, spec in STEP_MESH_SERVE.items():
        want = w1[label + "-serve"]
        for r, rk in enumerate(ranks):
            pre = normwise(torch.from_numpy(rk[f"{label}/prefill"]), want["prefill"])
            dec = torch.from_numpy(rk[f"{label}/decode"])
            dec_err = normwise(dec, want["decode"])
            check(pre <= LM_BF16_NORMWISE and dec_err <= LM_BF16_NORMWISE,
                  f"phase 19 {label} rank {r}: prefill {pre}, decode {dec_err} from world 1 "
                  f"(normwise, <= {LM_BF16_NORMWISE})")
            check(bool(rk[f"{label}/bitwise"]), f"phase 19 {label} rank {r}: prefill twice differs")
            got = torch.cat([torch.from_numpy(rk[f"{label}/prefill"]).argmax(-1)[None],
                             dec.argmax(-1)])
            check(torch.equal(got, want["tokens"]),
                  f"phase 19 {label} rank {r}: greedy tokens {got.tolist()} vs world 1's "
                  f"{want['tokens'].tolist()}")
            res[f"{label}-serve/rank{r}"] = dict(prefill_normwise=pre, decode_normwise=dec_err,
                                                 prefill_wall_s=float(rk[f"{label}/prefill_wall_s"]),
                                                 peak_bytes=int(rk[f"{label}/peak_bytes"]))
        log(f"  phase 19 {label} serving over (1, 2) ({spec['arch']} cut {spec['cut']}, bfloat16, "
            f"{spec['batch']} x {spec['prompt']} prompts, {spec['new']} decode steps "
            f"teacher-forced by world 1's greedy tokens): "
            f"{ {r: res[f'{label}-serve/rank{r}'] for r in range(2)} }; world 1 prefill "
            f"{want['prefill_wall_s']:.3f} s, peak {want['peak_bytes']} bytes; greedy tokens "
            f"equal ({card})")
    k1_launches = 0
    want = w1["gcn"]
    for shape in STEP_MESH_GNN:
        key = f"gcn/{shape[0]}x{shape[1]}"
        for r, rk in enumerate(ranks):
            n = int(rk[f"{key}/k1_launches"])
            check(n == STEP_MESH_K1, f"{key} rank {r}: {n} K1 launches, not {STEP_MESH_K1}")
            k1_launches += n
            loss = float(rk[f"{key}/loss"])
            check(abs(loss - want["loss"]) <= LM_TRAIN_LOSS_RTOL * abs(want["loss"]),
                  f"{key} rank {r}: loss {loss} vs world 1's {want['loss']}")
            check(bool(rk[f"{key}/bitwise"]), f"{key} rank {r}: two steps differ")
            errs = {k: normwise(torch.from_numpy(rk[f"{key}/g/{k}"]), g)
                    for k, g in want["grads"].items()}
            check(max(errs.values()) <= LM_TRAIN_GRAD_NORMWISE,
                  f"{key} rank {r}: gradients {errs} from world 1 (normwise)")
            res[f"{key}/rank{r}"] = dict(loss=loss, grad_normwise=errs, k1_launches=n,
                                         wall_s=float(rk[f"{key}/wall_s"]),
                                         peak_bytes=int(rk[f"{key}/peak_bytes"]))
        log(f"  phase 19 {key}: gcn-cora's train step at ogb_products' size ({want['grads']['w.0'].shape} "
            f"input weights), K1 on each rank ({STEP_MESH_K1} launches a rank): "
            f"{ {r: res[f'{key}/rank{r}'] for r in range(2)} } vs world 1's plain step loss "
            f"{want['loss']} ({want['wall_s']:.3f} s, peak {want['peak_bytes']} bytes; its batch "
            f"built in {want['host_batch_s']:.3f} s) ({card})")
    res.update(k1_launches=k1_launches, phase_s=time.perf_counter() - t_phase)
    return res


# ---------------------------------------------------------------------------
# phase 20: DCN-v2 over a mesh at FULL's widths (its tables' rows over
# "model", K5 on each rank's rows), world 1 here and two gloo ranks on the
# card; the dry run of a few cells on the meta device
# ---------------------------------------------------------------------------
DCN_MESH_SEED = 20
DCN_MESH_BULK = ((1, 2), (2, 1))   # serve_bulk at multi_hot=4, K5 on
DCN_MESH_TRAIN = ((2, 1), (1, 2))  # train_batch at multi_hot=1, AdamW, two steps
DCN_MESH_NORMWISE = 1e-5           # logits and scores against world 1 (float32, TF32 off)
DCN_MESH_LOSS_RTOL = 1e-5          # phase 18's card gates
DCN_MESH_STEP_NORMWISE = 1e-4      # each gradient and parameter leaf put together, after a step
DRYRUN_CELLS = (("dcn-v2", "train_batch"), ("dcn-v2", "serve_p99"), ("dcn-v2", "serve_bulk"),
                ("dcn-v2", "retrieval_cand"), ("gcn-cora", "full_graph_sm"),
                ("qwen2.5-3b", "decode_32k"))


def dcn_mesh_configs():
    """(the multi-hot serving config with K5 on, FULL as published: one-hot)."""
    from repro_torch.configs import get_arch

    full = get_arch("dcn-v2").full
    return dataclasses.replace(full, multi_hot=4, kernel=True), full


def dcn_mesh_batches(tmp: Path) -> None:
    """Every case's batch, seeded on the host, as npy files in ``tmp``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batches
    from repro_torch.launch import MeshLayout, build_step

    arch = get_arch("dcn-v2")
    hot, one = dcn_mesh_configs()
    sizes = {s.name: s.dims for s in arch.shapes}
    cases = {"bulk": next(recsys_batches(hot, sizes["serve_bulk"]["batch"], seed=DCN_MESH_SEED)),
             "p99": next(recsys_batches(one, sizes["serve_p99"]["batch"], seed=DCN_MESH_SEED)),
             "query": next(recsys_batches(one, 1, seed=DCN_MESH_SEED + 1)),
             "train": next(recsys_batches(one, sizes["train_batch"]["batch"],
                                          seed=DCN_MESH_SEED + 2))}
    # the candidates as the step rounds them for two ranks
    c = build_step("dcn-v2", "retrieval_cand", mesh=MeshLayout((1, 2), MESH_AXES)).meta["rows"]
    cases["query"]["candidates"] = np.random.default_rng(DCN_MESH_SEED).standard_normal(
        (c, one.embed_dim), dtype=np.float32)
    for case, batch in cases.items():
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                np.save(tmp / f"dcn_{case}_{k}.npy", v)


def dcn_mesh_batch(tmp: Path, case: str) -> dict:
    keys = {"bulk": ("dense", "sparse_ids"), "p99": ("dense", "sparse_ids"),
            "query": ("dense", "sparse_ids", "candidates"),
            "train": ("dense", "sparse_ids", "labels")}[case]
    return {k: np.load(tmp / f"dcn_{case}_{k}.npy") for k in keys}


def dcn_mesh_model(cfg, device, mesh=None):
    """FULL's seeded parameters (world 1's values; over a mesh this rank's
    slice of them)."""
    import torch

    from repro_torch.models import dcn_init

    dev = mesh.device if mesh is not None else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(DCN_MESH_SEED)
    return dcn_init(cfg, device=dev, generator=gen, mesh=mesh)


def k5_bulk_call(model, ids, mesh=None):
    """The K5 call ``embedding_bag`` makes at serve_bulk (over a mesh: on
    this rank's rows, the ids shifted by its first row), its inputs."""
    import torch

    from repro_torch.kernels import embed

    b, m = ids.shape[0], ids.shape[2]
    if mesh is not None:
        r0 = mesh.axis_index("model") * model.tables.shape[1]
        ids = ids - torch.tensor(r0, dtype=ids.dtype, device=ids.device)
    view = ids.permute(1, 0, 2)
    seg = torch.arange(b, dtype=torch.int32, device=ids.device)[:, None].expand(b, m).reshape(-1)
    return (lambda: embed.segment_embed_sorted(model.tables, view, seg, num_segments=b)), (
        model.tables, view, seg, b)


def dcn_mesh_world1(device, tmp: Path) -> dict:
    """World 1 of phase 20 on the card: serve_bulk at multi_hot=4 (K5),
    serve_p99 and retrieval_cand at multi_hot=1, the train kind's gradient
    and two AdamW steps; the answers to ``tmp`` for the ranks, every card
    tensor freed."""
    import torch

    from repro_torch.launch import build_step, train_state
    from repro_torch.models import embedding_bag

    hot, one = dcn_mesh_configs()
    out = {}
    model = dcn_mesh_model(hot, device).requires_grad_(False)
    bulk = dcn_mesh_batch(tmp, "bulk")
    step = build_step("dcn-v2", "serve_bulk", device=device)
    step.fn(model, bulk)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step.fn(model, bulk)
    torch.cuda.synchronize()
    out["bulk_wall_s"] = time.perf_counter() - t0
    np.save(tmp / "w1_bulk.npy", logits.cpu().numpy())
    with torch.inference_mode():
        k5, _ = k5_bulk_call(model, torch.as_tensor(bulk["sparse_ids"], device=device))
        out["k5_device_ms"] = graph_ms(k5)
    del model, logits, k5
    model = dcn_mesh_model(one, device).requires_grad_(False)
    p99 = dcn_mesh_batch(tmp, "p99")
    np.save(tmp / "w1_p99.npy", build_step("dcn-v2", "serve_p99", device=device).fn(
        model, p99).cpu().numpy())
    with torch.inference_mode():
        emb = embedding_bag(model.tables, torch.as_tensor(p99["sparse_ids"], device=device), one)
    np.save(tmp / "w1_p99_bags.npy", emb.cpu().numpy())
    np.save(tmp / "w1_scores.npy", build_step("dcn-v2", "retrieval_cand", device=device).fn(
        model, dcn_mesh_batch(tmp, "query")).cpu().numpy())
    del model, emb
    train = dcn_mesh_batch(tmp, "train")
    step = build_step("dcn-v2", "train_batch", device=device)
    state = train_state(dcn_mesh_model(one, device), step.opt)
    torch.cuda.reset_peak_memory_stats()
    step.grad(state["params"], train)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = step.grad(state["params"], train)
    torch.cuda.synchronize()
    out["grad_wall_s"] = time.perf_counter() - t0
    (tmp / "grad").mkdir()
    for k, v in grads.items():
        np.save(tmp / "grad" / f"{k}.npy", v.cpu().numpy())
    del grads
    p1, o1, _ = step.fn(state["params"], state["opt"], train)
    (tmp / "p1").mkdir()
    for k, v in p1.items():
        np.save(tmp / "p1" / f"{k}.npy", v.cpu().numpy())
    loss2 = step.fn(p1, o1, train)[2]
    out.update(loss=float(loss), loss2=float(loss2),
               peak_bytes=torch.cuda.max_memory_allocated())
    del state, p1, o1, loss, loss2
    torch.cuda.empty_cache()
    return out


def _split_stats(stats: list[dict]) -> dict:
    """Each leaf's normwise error from the ranks' (d2, r2, split): a split
    leaf's sums over the ranks, a whole one's from rank 0."""
    sums: dict = {}
    for r, st in enumerate(stats):
        for k, (d2, r2, split) in st.items():
            if split or r == 0:
                a, b = sums.get(k, (0.0, 0.0))
                sums[k] = (a + d2, b + r2)
    return {k: (d2 / r2) ** 0.5 if r2 else (0.0 if d2 == 0 else float("inf"))
            for k, (d2, r2) in sums.items()}


def _dcn_mesh_rank(rank: int, world: int, init: str, data: str, out: str,
                   device: str = "cuda") -> None:
    """One rank of phase 20's world 2 (gloo, both ranks on cuda:0): the
    serving cases (serve_bulk with K5 on this rank's rows over (1, 2) and
    (2, 1); serve_p99, its one-hot bags and retrieval_cand over (1, 2)) and
    the train kind over (2, 1) and (1, 2), each against world 1's answers in
    ``data``; to ``out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collective, distributed
    from repro_torch.kernels import embed, ref
    from repro_torch.launch import build_step, steps, train_state
    from repro_torch.models import embedding_bag

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        embed.load_library()  # built by the parent's phase 1: a load, not a build
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0") if on_card else torch.device(device)
    tmp = Path(data)
    hot, one = dcn_mesh_configs()
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    res = {}
    try:
        meshes = {s: distributed.make_mesh(s, MESH_AXES, device=dev) for s in ((1, 2), (2, 1))}

        bulk = dcn_mesh_batch(tmp, "bulk")
        want = np.load(tmp / "w1_bulk.npy")
        for shape in DCN_MESH_BULK:
            mesh, key = meshes[shape], f"bulk/{shape[0]}x{shape[1]}"
            step = build_step("dcn-v2", "serve_bulk", mesh=mesh)
            model = dcn_mesh_model(hot, dev, mesh).requires_grad_(False)
            step.fn(model, bulk)   # warm
            torch.cuda.synchronize() if on_card else None
            n0 = embed.launches
            t0 = time.perf_counter()
            logits = step.fn(model, bulk)
            torch.cuda.synchronize() if on_card else None
            res[f"{key}/wall_s"] = np.array(time.perf_counter() - t0)
            res[f"{key}/k5_launches"] = np.array(embed.launches - n0)
            res[f"{key}/normwise"] = np.array(normwise(
                logits, torch.from_numpy(steps._block(want, mesh, ("data",)))))
            res[f"{key}/finite"] = np.array(bool(torch.isfinite(logits).all()))
            if shape == (1, 2):
                # K5 on this rank's half of the tables, the ids shifted by its
                # first row: its plain version, its device time
                with torch.inference_mode():
                    k5, (tab, view, seg, b) = k5_bulk_call(
                        model, torch.as_tensor(bulk["sparse_ids"], device=dev), mesh)
                    got = k5()
                    exp = ref.segment_embed_ref(tab, view, seg, None, b)
                    check(torch.allclose(got, exp, rtol=EMBED_TOL[0], atol=EMBED_TOL[1]),
                          f"rank {rank}: K5 on its rows differs from its plain version")
                    res["k5/max_abs_err"] = np.array(float((got - exp).abs().max()))
                    # timed one rank at a time (both share the card); a sum
                    # over every rank between the turns holds the other back
                    for turn in range(world + 1):
                        collective.all_reduce_sum(torch.zeros(1), mesh)
                        if turn == rank:
                            res["k5/device_ms"] = np.array(graph_ms(k5) if on_card else 0.0)
                    res["k5/tables"] = np.array(list(tab.shape))
                    del got, exp, k5, tab, view, seg
            del model, logits
        torch.cuda.empty_cache() if on_card else None

        mesh = meshes[(1, 2)]
        model = dcn_mesh_model(one, dev, mesh).requires_grad_(False)
        p99 = dcn_mesh_batch(tmp, "p99")
        logits = build_step("dcn-v2", "serve_p99", mesh=mesh).fn(model, p99)
        res["p99/normwise"] = np.array(normwise(logits, torch.from_numpy(
            np.load(tmp / "w1_p99.npy"))))
        with torch.inference_mode():
            bags = embedding_bag(model.tables, torch.as_tensor(p99["sparse_ids"], device=dev),
                                 one, mesh).cpu()
        res["p99/bags_bitwise"] = np.array(bool(torch.equal(
            bags, torch.from_numpy(np.load(tmp / "w1_p99_bags.npy")))))
        scores = build_step("dcn-v2", "retrieval_cand", mesh=mesh).fn(
            model, dcn_mesh_batch(tmp, "query"))
        want = np.load(tmp / "w1_scores.npy")
        res["retrieval/normwise"] = np.array(normwise(scores, torch.from_numpy(
            steps._block(want.T, mesh, None).T.copy())))
        res["retrieval/columns"] = np.array(scores.shape[1])
        del model, logits, scores, bags
        torch.cuda.empty_cache() if on_card else None

        train = dcn_mesh_batch(tmp, "train")
        for shape in DCN_MESH_TRAIN:
            mesh, key = meshes[shape], f"train/{shape[0]}x{shape[1]}"
            step = build_step("dcn-v2", "train_batch", mesh=mesh)
            layout = (mesh, step.specs)
            state = train_state(dcn_mesh_model(one, dev, mesh), step.opt, layout)
            params, opt = state["params"], state["opt"]
            collective.traffic.clear()
            t0 = time.perf_counter()
            loss, grads = step.grad(params, train)
            torch.cuda.synchronize() if on_card else None
            res[f"{key}/grad_wall_s"] = np.array(time.perf_counter() - t0)
            res[f"{key}/traffic"] = np.array(json.dumps(collective.traffic))
            res[f"{key}/loss"] = np.array(float(loss))
            res[f"{key}/grad_stats"] = np.array(json.dumps(_grad_stats(grads, step.specs,
                                                                      tmp / "grad", mesh)))
            del grads
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            res[f"{key}/held_bytes"] = np.array(torch.cuda.memory_allocated() if on_card else 0)
            t0 = time.perf_counter()
            p1, o1, loss1 = step.fn(params, opt, train)
            torch.cuda.synchronize() if on_card else None
            res[f"{key}/step_wall_s"] = np.array(time.perf_counter() - t0)
            res[f"{key}/peak_bytes"] = np.array(torch.cuda.max_memory_allocated()
                                                if on_card else 0)
            want_fp = fingerprint(p1)
            again = step.fn(params, opt, train)
            res[f"{key}/bitwise"] = np.array(bool(fingerprint(again[0]) == want_fp
                                                  and torch.equal(again[2], loss1)))
            del again
            res[f"{key}/param_stats"] = np.array(json.dumps(_grad_stats(p1, step.specs,
                                                                       tmp / "p1", mesh)))
            loss2 = step.fn(p1, o1, train)[2]   # step 2's state dropped at once
            res[f"{key}/loss2"] = np.array(float(loss2))
            res[f"{key}/state_bytes"] = np.array(tree_bytes(params) + tree_bytes(opt))
            del state, params, opt, p1, o1, loss, loss1, loss2
            torch.cuda.empty_cache() if on_card else None
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def phase_dcn_mesh(device: str) -> dict:
    """Phase 20: the dry run of ``DRYRUN_CELLS`` on both production meshes
    (meta device) and of dcn-v2's train_batch at (1, 2); world 1 here
    (``dcn_mesh_world1``), then two gloo ranks on the card
    (``_dcn_mesh_rank``), each case held to world 1: logits and scores
    within ``DCN_MESH_NORMWISE``, one-hot bags bitwise, the loss within
    ``DCN_MESH_LOSS_RTOL``, each gradient and parameter leaf put together
    within ``DCN_MESH_STEP_NORMWISE``, the step bitwise repeatable, one K5
    launch a rank a multi-hot serve call. A rank that fails, or a spawn past
    ``SPAWN_TIMEOUT_S``, fails the smoke. Returns the phase's numbers,
    ``k5_launches`` K5's launches on both ranks' serve calls."""
    import gc
    import multiprocessing
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import MeshLayout
    from repro_torch.launch.dryrun import run_cell

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    res: dict = {"dryrun": {}}
    t0 = time.perf_counter()
    for arch, shape in DRYRUN_CELLS:
        for multi_pod in (False, True):
            rec = run_cell(arch, shape, multi_pod, verbose=False)
            check(rec["ok"], f"dry run {arch}:{shape} {rec['mesh']}: {rec.get('error')}")
            key = f"{arch}:{shape}:{rec['mesh']}"
            res["dryrun"][key] = {k: rec[k] for k in ("kind", "arg_bytes", "out_bytes",
                                                      "peak_bytes", "flops", "model_flops",
                                                      "collectives")}
            log(f"  phase 20 dry run {key} (rank 0, meta device, plain path): "
                f"{res['dryrun'][key]}")
    est = run_cell("dcn-v2", "train_batch", False, verbose=False,
                   layout=MeshLayout((1, 2), MESH_AXES))
    check(est["ok"], f"dry run dcn-v2:train_batch at 1x2: {est.get('error')}")
    res["dryrun_s"] = time.perf_counter() - t0
    tmp = Path(tempfile.mkdtemp(prefix="smoke_dcn_mesh_"))
    try:
        t0 = time.perf_counter()
        dcn_mesh_batches(tmp)
        res["batches_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        w1 = dcn_mesh_world1(device, tmp)
        res["world1_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        init = f"file://{tmp / 'rendezvous'}"
        outs = [tmp / f"rank{r}.npz" for r in range(2)]
        procs = [ctx.Process(target=_dcn_mesh_rank,
                             args=(r, 2, init, str(tmp), str(outs[r]), device))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        check(not hung, f"phase 20: {len(hung)} rank(s) still running after {SPAWN_TIMEOUT_S} s")
        check(all(p.exitcode == 0 for p in procs),
              f"phase 20: rank exit codes {[p.exitcode for p in procs]}")
        res["spawn_s"] = time.perf_counter() - t0
        ranks = [dict(np.load(o)) for o in outs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = card_line()
    k5_launches = 0
    for shape in DCN_MESH_BULK:
        key = f"bulk/{shape[0]}x{shape[1]}"
        for r, rk in enumerate(ranks):
            n = int(rk[f"{key}/k5_launches"])
            check(n == 1, f"phase 20 {key} rank {r}: {n} K5 launches for one serve call")
            k5_launches += n
            err = float(rk[f"{key}/normwise"])
            check(bool(rk[f"{key}/finite"]) and err <= DCN_MESH_NORMWISE,
                  f"phase 20 {key} rank {r}: logits {err} from world 1 (normwise)")
        res[key] = dict(normwise=[float(rk[f"{key}/normwise"]) for rk in ranks],
                        wall_s=[float(rk[f"{key}/wall_s"]) for rk in ranks],
                        world1_wall_s=w1["bulk_wall_s"])
        log(f"  phase 20 serve_bulk over {shape} (262,144 rows, multi_hot=4, K5 on each rank's "
            f"rows, one launch a rank): {res[key]} ({card})")
    res["k5"] = dict(rank_device_ms=[float(rk["k5/device_ms"]) for rk in ranks],
                     rank_tables=ranks[0]["k5/tables"].tolist(),
                     world1_device_ms=w1["k5_device_ms"],
                     max_abs_err=max(float(rk["k5/max_abs_err"]) for rk in ranks))
    log(f"  phase 20 K5 at serve_bulk on a rank's half tables {res['k5']['rank_tables']} (ids "
        f"shifted by its first row) device_ms by rank {res['k5']['rank_device_ms']} vs world 1's "
        f"whole tables {w1['k5_device_ms']:.6f}; == its plain version (max abs err "
        f"{res['k5']['max_abs_err']:g}) ({card})")
    for r, rk in enumerate(ranks):
        for key in ("p99/normwise", "retrieval/normwise"):
            check(float(rk[key]) <= DCN_MESH_NORMWISE,
                  f"phase 20 rank {r}: {key} {float(rk[key])} from world 1")
        check(bool(rk["p99/bags_bitwise"]), f"phase 20 rank {r}: one-hot bags differ from "
              f"world 1's")
    res["one_hot"] = dict(p99_normwise=[float(rk["p99/normwise"]) for rk in ranks],
                          retrieval_normwise=[float(rk["retrieval/normwise"]) for rk in ranks],
                          retrieval_columns=[int(rk["retrieval/columns"]) for rk in ranks])
    log(f"  phase 20 over (1, 2) at multi_hot=1: serve_p99 and retrieval_cand {res['one_hot']}; "
        f"one-hot bags bitwise equal to world 1's ({card})")
    for shape in DCN_MESH_TRAIN:
        key = f"train/{shape[0]}x{shape[1]}"
        for r, rk in enumerate(ranks):
            for lk, wk in (("loss", "loss"), ("loss2", "loss2")):
                got = float(rk[f"{key}/{lk}"])
                check(abs(got - w1[wk]) <= DCN_MESH_LOSS_RTOL * abs(w1[wk]),
                      f"phase 20 {key} rank {r}: {lk} {got} vs world 1's {w1[wk]}")
            check(bool(rk[f"{key}/bitwise"]), f"phase 20 {key} rank {r}: the step is not "
                  f"repeatable")
        errs = {}
        for what in ("grad_stats", "param_stats"):
            e = _split_stats([json.loads(str(rk[f"{key}/{what}"])) for rk in ranks])
            worst = max(e, key=e.get)
            check(e[worst] <= DCN_MESH_STEP_NORMWISE,
                  f"phase 20 {key}: {what} {worst} {e[worst]} from world 1 (normwise)")
            errs[what] = (worst, e[worst])
        res[key] = dict(loss=[float(rk[f"{key}/loss"]) for rk in ranks], world1_loss=w1["loss"],
                        loss2=[float(rk[f"{key}/loss2"]) for rk in ranks],
                        world1_loss2=w1["loss2"], worst=errs,
                        grad_wall_s=[float(rk[f"{key}/grad_wall_s"]) for rk in ranks],
                        world1_grad_wall_s=w1["grad_wall_s"],
                        step_wall_s=[float(rk[f"{key}/step_wall_s"]) for rk in ranks],
                        peak_bytes=[int(rk[f"{key}/peak_bytes"]) for rk in ranks],
                        held_bytes=[int(rk[f"{key}/held_bytes"]) for rk in ranks],
                        state_bytes=[int(rk[f"{key}/state_bytes"]) for rk in ranks],
                        world1_peak_bytes=w1["peak_bytes"],
                        traffic=[json.loads(str(rk[f"{key}/traffic"])) for rk in ranks])
        log(f"  phase 20 train_batch over {shape} (65,536 rows, multi_hot=1, AdamW, two steps): "
            f"{res[key]} ({card})")
    measured = res["train/1x2"]["peak_bytes"][0]
    res["peak_estimate"] = dict(dryrun_peak_bytes=est["peak_bytes"],
                                dryrun_arg_bytes=est["arg_bytes"], measured_peak_bytes=measured,
                                measured_held_bytes=res["train/1x2"]["held_bytes"][0],
                                ratio=est["peak_bytes"] / measured if measured else None)
    log(f"  phase 20 estimator: the dry run's peak_bytes of dcn-v2 train_batch at MeshLayout((1, "
        f"2)) {est['peak_bytes']} (its arg_bytes {est['arg_bytes']}) vs rank 0's measured "
        f"max_memory_allocated over the same step {measured} (held before it "
        f"{res['peak_estimate']['measured_held_bytes']}) ({card})")
    res.update(k5_launches=k5_launches, phase_s=time.perf_counter() - t_phase, card=card)
    return res


def main(argv: list[str]) -> int:
    if argv not in ([], ["--rows"]):
        print(f"usage: python3 chip_smoke.py [--rows]; got {argv}", file=sys.stderr)
        return 2
    rows_only = argv == ["--rows"]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.graphs.generators import planted_dense, rmat
        from repro_torch.kernels import build, compact, embed, peel, segsum
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    device = "cuda"
    t_start = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, numpy {np.__version__}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    sources = [segsum.SOURCE, peel.SOURCE, compact.SOURCE, embed.SOURCE]
    build.build_all(sources)  # one nvcc each, all at once
    for module in (segsum, peel, compact, embed):
        module.load_library()
    log(f"  K1, K2, K3, K4, K5 built and loaded in {time.perf_counter() - t0:.3f} s from "
        f"{', '.join(src.name for src in sources)}")
    for r in ptxas_records():
        log(f"  ptxas {r['source']} {r['function'][:96]}: {r['registers']} registers, "
            f"{r['smem_bytes']} bytes smem, spill {r['spill_store_bytes']} / "
            f"{r['spill_load_bytes']} bytes")
    if rows_only:
        t0 = time.perf_counter()
        b_src, b_dst, b_deg = bucket_lanes(device)
        log(f"  phase 12's lane bucket built in {time.perf_counter() - t0:.3f} s: "
            f"{tuple(b_src.shape)} lanes, V={FUSED_COO['n']}")
        k2_rows, k1_rows = rows_kernel_timing(b_src, b_dst, b_deg, FUSED_COO["n"], device)
        log(json.dumps({"k2_rows": k2_rows, "k1_rows": k1_rows,
                        "smoke_s": time.perf_counter() - t_start}, default=str))
        log(card_line())
        return 0

    t0 = time.perf_counter()
    g = rmat(SCALE, EDGE_FACTOR, seed=0)
    g.dst_sorted()
    g_small = rmat(15, EDGE_FACTOR, seed=0)
    log(f"  graphs built on the host in {time.perf_counter() - t0:.3f} s: rmat({SCALE}) "
        f"|V|={g.n_nodes} |E|={g.n_edges} lanes={g.src.shape[0]}")
    t0 = time.perf_counter()
    g_planted, _, block_density = planted_dense(**PLANTED)
    g_planted.dst_sorted()
    log(f"  planted_dense({PLANTED}) built in {time.perf_counter() - t0:.3f} s: "
        f"|V|={g_planted.n_nodes} |E|={g_planted.n_edges} lanes={g_planted.src.shape[0]} "
        f"block density {block_density!r}")

    log("phase 2: kernels against their plain versions on the card")
    k1, k2 = phase_kernels(g, device)
    compact_err = phase_compact_cases(device)
    embed_err = phase_embed_cases(device)

    log("phase 3: peel_threshold bits")
    phase_threshold(device)

    log("phase 4: P-Bahmani at full width")
    peel_launches, peel_times, peel_answers = phase_pbahmani(g, device, SCALE)

    log("phase 5: CBDS-P at full width")
    cbds_launches, cbds_k1_launches, cbds_times, cbds_answer = phase_cbds(
        g, g_small, device, SCALE)

    log("phase 6: pruned P-Bahmani on the planted block at full width")
    pruned_launches, pruned_times, k4_inputs = phase_pruned(g_planted, device)

    log("phase 7: K3 and K4 at the pruned path's inputs")
    compact_times = phase_compact_timing(k4_inputs)

    log("phase 8: pruned P-Bahmani on the RMAT graph (falls back)")
    fallback_launches, fallback_k1 = phase_pruned_fallback(g, device)

    log("phase 9: refinement")
    refine_launches, refine_times = phase_refine(g, g_small, device)

    log("phase 10: DCN-v2 serving and retrieval at full width (multi_hot=4, K5 on)")
    t0 = time.perf_counter()
    k5_launches, k5, dcn_times = phase_dcn(device)
    dcn_times["phase_s"] = time.perf_counter() - t0
    log(f"  phase 10 took {dcn_times['phase_s']:.3f} s")

    log("phase 11: the streaming DeltaEngine on a planted block, churn batches")
    t0 = time.perf_counter()
    stream_launches, stream_times, stream_answers = phase_stream(device)
    stream_times["phase_s"] = time.perf_counter() - t0
    log(f"  phase 11 took {stream_times['phase_s']:.3f} s; launches {stream_launches}")

    log("phase 12: the fused multi-tenant service (a lane bucket of 32 tenants, a dense "
        "bucket of 64)")
    t0 = time.perf_counter()
    fused_launches, fused_times, k2_rows, k1_rows, flush_round = phase_fused(device)
    fused_times["phase_s"] = time.perf_counter() - t0
    log(f"  phase 12 took {fused_times['phase_s']:.3f} s; launches {fused_launches}")

    log("phase 13: the sharded tier (world 1 on NCCL, world 2 on gloo)")
    t0 = time.perf_counter()
    shard_launches, shard_times = phase_sharded(g, device, peel_answers, cbds_answer,
                                                stream_answers)
    shard_times["phase_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {shard_times['phase_s']:.3f} s; launches {shard_launches}, "
        f"collectives {shard_times['collectives']}")

    log("phase 14: the invariant linter, the audited libraries, host syncs a pass")
    t0 = time.perf_counter()
    lint = phase_lint(g, device, SCALE, flush_round)
    lint["phase_s"] = time.perf_counter() - t0
    log(f"  phase 14 took {lint['phase_s']:.3f} s")

    log("phase 15: the training runtime: DCN-v2 training at full width, P-Bahmani under "
        "worker loss")
    t0 = time.perf_counter()
    train_times = phase_train(device)
    restart_launches, restart_times = phase_peel_restarts(
        g, device, peel_answers[0.1], shard_times["pbahmani_0.1"]["median_s"])
    train_times["peel_with_restarts"] = restart_times
    train_times["phase_s"] = time.perf_counter() - t0
    log(f"  phase 15 took {train_times['phase_s']:.3f} s; launches {restart_launches}")

    log("phase 16: the GNN zoo (GCN, SchNet, EGNN, MACE at FULL's widths) over K1's [E, D] "
        "float32 path")
    k1_gnn_launches, k1_gnn, gnn_times = phase_gnn(device)
    log(f"  phase 16 took {gnn_times['phase_s']:.3f} s (its main path "
        f"{gnn_times['main_path_s']:.3f} s); K1 launches {k1_gnn_launches}")

    log("phase 17: the transformer family's serving path (qwen2.5, mistral-nemo, phi3-mini, "
        "deepseek-v3, grok-1 at published widths, bfloat16)")
    lm_times = phase_lm(device)
    log(f"  phase 17 took {lm_times['phase_s']:.3f} s; no kernel of K1-K5 on its path")

    log("phase 18: LM training (qwen2.5 at 12 layers, grok-1 at 1 layer, deepseek-v3's first "
        "(dense) layer with MTP, the checkpointed loop) at published widths, bfloat16")
    lm_train_times = phase_lm_train(device)
    log(f"  phase 18 took {lm_train_times['phase_s']:.3f} s; no kernel of K1-K5 on its path")

    log("phase 19: build_step over a mesh (mistral-nemo tp_sp with FSDP and qwen2.5 zero3 "
        "training in float32, qwen2.5 and deepseek-v3 prefill and decode in bfloat16, gcn-cora "
        "at ogb_products' size with K1 on each rank; qwen2.5 tp_sp over (1, 4), each rank its "
        "sequence block of every head), world 1, two and four gloo ranks on the card")
    step_mesh_times = phase_step_mesh(device)
    step_mesh_k1 = step_mesh_times["k1_launches"]
    log(f"  phase 19 took {step_mesh_times['phase_s']:.3f} s (world 1 "
        f"{step_mesh_times['world1_s']:.3f} s, world 2 {step_mesh_times['spawn_s'][2]:.3f} s, "
        f"world 4 {step_mesh_times['spawn_s'][4]:.3f} s); K1 launches {step_mesh_k1}")

    log("phase 20: DCN-v2 over a mesh at FULL's widths (the tables' rows over 'model', K5 on "
        "each rank's rows), world 1 and two gloo ranks on the card; the dry run on the meta device")
    dcn_mesh_times = phase_dcn_mesh(device)
    log(f"  phase 20 took {dcn_mesh_times['phase_s']:.3f} s (world 1 "
        f"{dcn_mesh_times['world1_s']:.3f} s, world 2 {dcn_mesh_times['spawn_s']:.3f} s, the dry "
        f"run {dcn_mesh_times['dryrun_s']:.3f} s); K5 launches {dcn_mesh_times['k5_launches']}")

    vp_k1_launches = shard_times["mesh"]["k1_launches"]
    k2_launches = (peel_launches + cbds_launches + pruned_launches["peel_edges"]
                   + fallback_launches + refine_launches + stream_launches["peel_edges"]
                   + fused_launches["peel_edges"] + shard_launches["peel_edges"]
                   + restart_launches["peel_edges"])
    k1_launches = (cbds_k1_launches + pruned_launches["segment_sum_sorted"] + fallback_k1
                   + stream_launches["segment_sum_sorted"]
                   + fused_launches["segment_sum_sorted"]
                   + shard_launches["segment_sum_sorted"]
                   + restart_launches["segment_sum_sorted"])
    log(f"main path: K2 launches P-Bahmani (eps 0.1 and 0) {peel_launches}, CBDS-P "
        f"{cbds_launches}, pruned {pruned_launches['peel_edges']}, pruned fallback "
        f"{fallback_launches}, refinement {refine_launches}; K1 {k1_launches} (CBDS-P's "
        f"augmentation round {cbds_k1_launches}, the degrees of the pruned queries' plans, "
        f"preps and buckets {pruned_launches['segment_sum_sorted']}, of the fallbacks' plans "
        f"and preps {fallback_k1}); K3 "
        f"{pruned_launches['prefix_sum']}, K4 {pruned_launches['stream_compact']} (pruned, "
        f"eps 0.1 and 0); K5 {k5_launches} (DCN-v2: 8 serve_p99, 1 serve_bulk, 1 "
        f"retrieval_cand); the stream (phase 11): K1 "
        f"{stream_launches['segment_sum_sorted']}, K2 {stream_launches['peel_edges']}, K3 "
        f"{stream_launches['prefix_sum']}, K4 {stream_launches['stream_compact']}; the fused "
        f"service (phase 12): K2 rows {fused_launches['peel_edges_rows']}, K1 rows "
        f"{fused_launches['segment_sum_rows']}, K1 {fused_launches['segment_sum_sorted']}, "
        f"K2 {fused_launches['peel_edges']}, K3 {fused_launches['prefix_sum']}, K4 "
        f"{fused_launches['stream_compact']}; the sharded tier (phase 13): K2 "
        f"{shard_launches['peel_edges']}, K1 {shard_launches['segment_sum_sorted']}; "
        f"peel_with_restarts (phase 15): K2 {restart_launches['peel_edges']}, K1 "
        f"{restart_launches['segment_sum_sorted']}; the GNNs (phase 16): K1 at [E, D] float32 "
        f"{k1_gnn_launches}; vp_segment_sum on both ranks of phase 13's mesh world 2: K1 at "
        f"[E, D] float32 {vp_k1_launches}; phase 19's GCN steps over a mesh (both ranks): K1 "
        f"{step_mesh_k1}; phase 20's serve_bulk over a mesh (both ranks): K5 "
        f"{dcn_mesh_times['k5_launches']}")
    rows = {
        "segment_sum_sorted": (k1_launches, k1["max_abs_err"], k1),
        "peel_edges": (k2_launches, k2["max_abs_err"], k2),
        "prefix_sum": (pruned_launches["prefix_sum"] + stream_launches["prefix_sum"]
                       + fused_launches["prefix_sum"],
                       compact_err, compact_times["prefix_sum"]),
        "stream_compact": (pruned_launches["stream_compact"] + stream_launches["stream_compact"]
                           + fused_launches["stream_compact"],
                           compact_err, compact_times["stream_compact_edge"]),
        "segment_embed": (k5_launches + dcn_mesh_times["k5_launches"],
                          max(embed_err, k5["max_abs_err"], dcn_mesh_times["k5"]["max_abs_err"]),
                          k5),
        "peel_edges_rows": (fused_launches["peel_edges_rows"], k2_rows["max_abs_err"], k2_rows),
        "segment_sum_rows": (fused_launches["segment_sum_rows"], k1_rows["max_abs_err"],
                             k1_rows),
        "segment_sum_sorted_ed": (k1_gnn_launches + vp_k1_launches + step_mesh_k1,
                                  k1_gnn["max_abs_err"], k1_gnn),
    }
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": n,
        "max_abs_err": err,
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "parity": "ok",
    } for name, (n, err, t) in rows.items()]
    log(json.dumps({"k1_by_type": k1["by_type"],
                    "k2": k2,
                    "compact_by_call": compact_times,
                    "end_to_end_s": {"pbahmani": {str(k): v for k, v in peel_times.items()},
                                     "cbds": cbds_times,
                                     "pruned": {str(k): v for k, v in pruned_times.items()},
                                     "refine": refine_times},
                    "k5_at_serve_bulk": k5,
                    "dcn_v2": dcn_times,
                    "stream": stream_times,
                    "fused": fused_times,
                    "sharded": shard_times,
                    "lint": lint,
                    "train": train_times,
                    "gnn": gnn_times,
                    "lm": lm_times,
                    "lm_train": lm_train_times,
                    "step_mesh": step_mesh_times,
                    "dcn_mesh": dcn_mesh_times,
                    "k2_rows": k2_rows,
                    "k1_rows": k1_rows,
                    "smoke_s": time.perf_counter() - t_start}, default=str))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
