# Developer entry points. Tier-1 is the same command CI runs.
PY ?= python
export PYTHONPATH := src

# algorithm-core test modules: the coverage floor is enforced on these
COV_TESTS := tests/test_core_algorithms.py tests/test_core_density.py \
	tests/test_distributed.py tests/test_graphs.py tests/test_stream.py \
	tests/test_prune.py tests/test_oracle_properties.py tests/test_shard.py \
	tests/test_tenants.py tests/test_refine.py tests/test_obs.py \
	tests/test_telemetry.py tests/test_kernels.py tests/test_analysis.py

.PHONY: test coverage lint lint-invariants lint-invariants-torch bench-smoke bench-prune-smoke \
	bench-shard-smoke \
	bench-tenants-smoke bench-refine-smoke bench-density-smoke \
	bench-epsilon-smoke bench-kernels-smoke bench-obs-smoke scrape-smoke \
	bench-check bench-baseline \
	bench-stream-large bench-shard-large bench-tenants-large \
	bench-check-large bench-baseline-large \
	bench metrics-demo metrics-serve-demo deps-dev

test:
	$(PY) -m pytest -x -q

# line-coverage floor on the algorithm core + streaming + refinement
# subsystems (needs pytest-cov: `make deps-dev`)
coverage:
	$(PY) -m pytest -q $(COV_TESTS) \
		--cov=repro.core --cov=repro.stream --cov=repro.refine \
		--cov=repro.obs --cov=repro.analysis \
		--cov-report=term-missing --cov-fail-under=75

# ruff gate (needs ruff: `make deps-dev`); config in pyproject.toml
lint:
	$(PY) -m ruff check src benchmarks tests examples

# invariant linter (repro.analysis): trace-safety, auditor coverage,
# exactness-proof, and collective-parity rules over the package tree.
# Exit 1 on any unsuppressed finding — the same gate CI runs.
lint-invariants:
	$(PY) -m repro.analysis --show-suppressed src/repro

# the same linter's torch rules over the PyTorch/CUDA port (repro_torch.analysis):
# host syncs in pass loops, kernel-library loads, proof scopes, collectives
lint-invariants-torch:
	$(PY) -m repro_torch.analysis --show-suppressed src/repro_torch

# fast end-to-end sanity: the streaming benchmark at toy scale
# (writes BENCH_stream.json — the benchmark-trajectory artifact)
bench-smoke:
	$(PY) benchmarks/bench_stream.py --smoke --emit-metrics

# candidate-pruning parity + zero-recompile sanity at toy scale
bench-prune-smoke:
	$(PY) benchmarks/bench_prune.py --smoke --emit-metrics

# sharded==single-device parity on a forced 4-device CPU mesh
bench-shard-smoke:
	XLA_FLAGS=--xla_force_host_platform_device_count=4 \
		$(PY) benchmarks/bench_shard.py --smoke --emit-metrics

# fused multi-tenant parity (batched == unbatched bit-identical) +
# zero-recompile across tenant evict/join at toy scale
bench-tenants-smoke:
	$(PY) benchmarks/bench_tenants.py --smoke --emit-metrics

# near-optimal refinement: certified duality-gap closure (monotone,
# <= 1%), oracle sandwich vs exact, fused-rounds parity, zero recompiles
bench-refine-smoke:
	$(PY) benchmarks/bench_refine.py --smoke --emit-metrics

# quality-ratio trajectory cells (paper Tables 3 and 2 at CI scale)
bench-density-smoke:
	$(PY) benchmarks/bench_density.py --smoke --emit-metrics

bench-epsilon-smoke:
	$(PY) benchmarks/bench_epsilon.py --smoke --emit-metrics

# kernel tier (ISSUE 7): band-skip grid win, scatter-vs-MXU roofline,
# kernel-on/off bit-identity, zero steady-state compiles
bench-kernels-smoke:
	$(PY) benchmarks/bench_kernels.py --smoke --emit-metrics

# mesh-wide telemetry plane (ISSUE 10): three real worker processes spool
# AND push to a collector; fleet quantiles must be bit-identical to the
# pooled oracle, both transports must agree, /metrics must lint (the
# forced 4-device mesh makes each worker a multi-device process, the
# topology the collector exists for). Writes FLEET_snapshot.json.
bench-obs-smoke:
	XLA_FLAGS=--xla_force_host_platform_device_count=4 \
		$(PY) benchmarks/bench_obs.py --smoke --emit-metrics

# scrape endpoint over a live worker: /metrics lints (adversarial tenant
# names round-trip the label escaping), /slo + /snapshot well-formed,
# zero steady recompiles with the server up, clean shutdown
scrape-smoke:
	$(PY) benchmarks/scrape_smoke.py

# benchmark-trajectory gate: compare the BENCH_*.json files the smokes
# wrote against the committed baseline (>25% regression fails)
bench-check:
	$(PY) benchmarks/check_regression.py

# refresh benchmarks/baseline.json from the current BENCH_*.json files
# (run the eight smokes first)
bench-baseline: bench-smoke bench-prune-smoke bench-shard-smoke \
		bench-tenants-smoke bench-refine-smoke bench-density-smoke \
		bench-epsilon-smoke bench-kernels-smoke
	$(PY) benchmarks/check_regression.py --update

# large-scale tier (ROADMAP P2): 16k-node graphs, run by the scheduled
# large-bench workflow (cron + manual dispatch), gated against the
# separate benchmarks/baseline_large.json band with a looser tolerance
# (longer windows, noisier shared runners)
bench-stream-large:
	$(PY) benchmarks/bench_stream.py --large --emit-metrics

bench-shard-large:
	XLA_FLAGS=--xla_force_host_platform_device_count=4 \
		$(PY) benchmarks/bench_shard.py --large --emit-metrics

bench-tenants-large:
	$(PY) benchmarks/bench_tenants.py --large --emit-metrics

bench-check-large:
	$(PY) benchmarks/check_regression.py --only stream,shard,tenants \
		--baseline benchmarks/baseline_large.json --tolerance 0.4

# refresh benchmarks/baseline_large.json from the current BENCH_*.json
# files (run the three large benches first)
bench-baseline-large: bench-stream-large bench-shard-large \
		bench-tenants-large
	$(PY) benchmarks/check_regression.py --only stream,shard,tenants \
		--baseline benchmarks/baseline_large.json --update

bench:
	$(PY) benchmarks/run.py

# end-to-end observability demo: the fraud-rings example with tracing on,
# finishing with the Prometheus exposition-format dump of the run
metrics-demo:
	$(PY) examples/streaming_fraud.py --emit-metrics

# same demo through the live telemetry plane: the operator loop reads
# burn-rate alerts from the real /slo endpoint each step (an impossible
# latency objective pages, the 8s headroom one stays green) and the final
# /metrics scrape is linted as exposition text
metrics-serve-demo:
	$(PY) examples/streaming_fraud.py --serve-metrics --emit-metrics

deps-dev:
	pip install -r requirements-dev.txt
