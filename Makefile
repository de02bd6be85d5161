PY ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: test test-fast test-dist test-multiproc test-faults lint bench-entropy \
	bench-entropy-smoke bench-chain bench bench-all bench-all-smoke \
	bench-check

# Static analysis: repro-lint (the five AST invariant passes diffed
# against repro-lint.baseline.json -- see docs/static_analysis.md) plus
# the ruff subset configured in pyproject.toml.  ruff is pinned in
# requirements-dev.txt; containers without it skip that half gracefully
# (CI always installs it, so the zero-findings gate still holds).
lint:
	$(PY) -m repro.analysis
	$(PY) -m repro_torch.analysis
	@if $(PY) -m ruff --version >/dev/null 2>&1; then \
	  $(PY) -m ruff check src tests benchmarks; \
	else \
	  echo "ruff not installed; skipping style gate" \
	       "(pip install -r requirements-dev.txt)"; \
	fi

# Tier-1 verify (full suite).
test:
	$(PY) -m pytest -q

# Fast loop: skip the slow end-to-end markers.
test-fast:
	$(PY) -m pytest -q -m "not slow"

# Distributed + checkpoint suite under a 2-device host-platform mesh.
# (The sharded tests re-exec themselves with their own device count; the
# flag here covers any test that runs a mesh in-process.)
test-dist:
	XLA_FLAGS=--xla_force_host_platform_device_count=2 \
	$(PY) -m pytest -q tests/test_distributed.py tests/test_checkpoint.py \
	    tests/test_sharding.py tests/test_elastic.py

# Multi-process tier: jax.distributed launch emulation, per-rank shard
# writers + NCKM manifest, crash tolerance.  The 2-process byte-identity
# tests spawn real subprocesses (repro.launch.distributed.spawn_emulated)
# and are independent of the in-process device count.
test-multiproc:
	$(PY) -m pytest -q tests/test_multiprocess.py

# Fault-tolerance tier: corruption fuzz over NCK1/2/3/4 + NCKM (every
# flip/truncation must raise a structured IntegrityError), the
# REPRO_FAULTS injection registry, the self-healing manifest commit
# (quarantine / rollback / convergence), and the injected-fleet tests.
# See docs/robustness.md.
test-faults:
	$(PY) -m pytest -q tests/test_faults.py

# Entropy stage: serial vs parallel host codecs across block sizes, plus
# the device rANS codec vs the threaded-zlib finalize at 1/16/64 MB.
# Also writes the BENCH_entropy.json artifact rows.
bench-entropy:
	$(PY) benchmarks/bench_entropy.py --json BENCH_entropy.json

# Device-codec rows only (the CI artifact): quick smoke at 1/16/64 MB.
bench-entropy-smoke:
	$(PY) benchmarks/bench_entropy.py --smoke --json BENCH_entropy.json

# Host-resident vs device-resident reference chain (single + sharded).
# Also rides along in `make bench` via bench_compression.
bench-chain:
	$(PY) benchmarks/bench_chain.py

bench:
	$(PY) benchmarks/run.py

# The committed perf trajectory: write BENCH_entropy.json,
# BENCH_chain.json, BENCH_compression.json and BENCH_scaling.json into
# the repo root in the stable diffable schema (machine/config header +
# named rows).  The scaling bench launches emulated multi-process runs.
bench-all:
	$(PY) benchmarks/run.py --bench-all --out-dir .

# Reduced in-process variant for CI: rows are a name-identical subset of
# the full bench-all rows, so bench-check gates them against the
# committed artifacts.
OUT ?= .
bench-all-smoke:
	mkdir -p $(OUT)
	$(PY) benchmarks/run.py --bench-all --smoke --out-dir $(OUT)

# Regression gate: compare fresh BENCH JSONs in $(OUT) against the
# committed ones.  TOL is the allowed fractional timing growth (local
# same-machine runs keep the 0.5 default; CI passes a generous value
# because runner hardware differs from the tracked machine).
TOL ?= 0.5
RATIO_TOL ?= 0.05
bench-check:
	@rc=0; for b in entropy chain compression scaling; do \
	  $(PY) benchmarks/check_regression.py \
	    --tracked BENCH_$$b.json --current $(OUT)/BENCH_$$b.json \
	    --tolerance $(TOL) --ratio-tolerance $(RATIO_TOL) || rc=1; \
	done; exit $$rc
