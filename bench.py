#!/usr/bin/env python
"""Benchmark: random-effect models trained per second + sub-metrics.

Not yet a benchmark of the H100: it prints no device name and takes no trace
(ROADMAP 1.1 rebuilds it). chip_smoke.py is what runs the main path on the GPU
today. No rate in this file is measured on the H100.

Primary metric (BASELINE.json headline, ≥1M models/min = 16,667 models/sec):
a movieLens-per-user-shaped fleet of independent per-entity logistic
regressions solved by the bucketed vmapped on-device solver
(gdmix_tpu/models/random_effect_lr.py path).

Named sub-metrics in the same JSON line:
  re_heavy_tail_models_per_sec — pareto sample counts 2..2048 (straggler mix)
  re_sharded_heavy_tail_models_per_sec — the same pareto mix through the
      sharded device plane (fit_flat → fit_records_sharded: routing +
      on-device per-tier grouping), fit-only
  re_stage_models_per_sec — fit_flat + avro export + reload through the
      production class (the per-partition stage the reference's trainer runs)
  re_wide_support_models_per_sec — u_cap ≥ 256 per-entity feature support
  re_score_records_per_sec — per-record scoring through the sparse-CSR
      scorer (host join + device binary-search join; O(nnz) at any (E, D))
  detext_rows_per_sec — deep-tower (DeText-style) jitted Adam step rate
      (text-CNN + wide tower, B=4096 L=16 vocab=30k)
  fe_funcalls_per_sec — fixed-effect loss+grad at N=5M, D=10k, K=16 through
      FixedEffectLRModel._objective_fun (the production class's own dispatch;
      grad_mode=auto resolves to the two-level one-hot "block" path here)
  fe_wide_d_funcalls_per_sec — the same funcall at D=1M (past block's
      ceiling) on Zipf-1.2 power-law ids: auto resolves to the hot/cold
      HYBRID (adaptive top-A features through the compact block path, cold
      tail through XLA gather/scatter-add)
  fe_wide_d_uniform_funcalls_per_sec — the same at uniform ids (no hot set):
      the hybrid builder declines and auto degrades to the scatter path
  re_stage_solve_bound_models_per_sec + re_stage_decomposition — the stage
      rate with this run's measured link terms divided out (bytes_up/down,
      phase walls, link fraction)

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "submetrics"}.
Once the primary is measured the line is GUARANTEED: a watchdog emits it with
whichever submetrics completed if BENCH_BUDGET_S (default 1500 s) expires, so
a stalled submetric does not cost the whole measurement.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from gdmix_tpu.data.bucketing import bucketize
from gdmix_tpu.io.input_pipeline import EntityGroup
from gdmix_tpu.models.random_effect_lr import _lbfgs_solver, _newton_solver

TARGET_MODELS_PER_SEC = 1_000_000 / 60.0   # ≥1M models/min/chip

NUM_ENTITIES = int(os.environ.get("BENCH_ENTITIES", 100_000))
HEAVY_ENTITIES = int(os.environ.get("BENCH_HEAVY_ENTITIES", 20_000))
WIDE_ENTITIES = int(os.environ.get("BENCH_WIDE_ENTITIES", 4_096))
STAGE_ENTITIES = int(os.environ.get("BENCH_STAGE_ENTITIES", NUM_ENTITIES))
RUN_FE = os.environ.get("BENCH_FE", "1") != "0"
FE_ROUND1_FUNCALL_S = 1.03  # an earlier accelerator's one-hot path (N=5M, D=10k)


class _Schema:
    uid_column_name = "uid"
    label_column_name = "response"
    weight_column_name = None
    prediction_score_column_name = "predictionScore"
    prediction_score_per_coordinate_column_name = "predictionScorePerCoordinate"


def probe_link(mb: int = 8):
    """One-time host<->device link probe: (up_bytes_per_s, down_bytes_per_s,
    dispatch_latency_s). Feeds the stage decomposition: the solve-bound
    rate divides out the link terms using THIS run's measured bandwidth."""
    from gdmix_tpu.util.timing import measure_dispatch_latency_s
    lat = measure_dispatch_latency_s()
    a = np.random.RandomState(0).rand(mb << 20 >> 3)   # mb MB of f64
    float(jnp.sum(jax.device_put(a)))   # warm the put + reduction compile
    t0 = time.time()
    d = jax.device_put(a)
    float(jnp.sum(d))   # scalar fetch = sync
    up_s = time.time() - t0
    t0 = time.time()
    _ = np.asarray(d)
    down_s = time.time() - t0
    nb = a.nbytes
    sys.stderr.write(f"bench[link]: up {nb / up_s / 1e6:.1f} MB/s, "
                     f"down {nb / down_s / 1e6:.1f} MB/s, dispatch "
                     f"{lat * 1e3:.1f} ms\n")
    return nb / up_s, nb / down_s, lat


def make_workload(num_entities: int, seed: int = 0, d: int = 24,
                  max_nnz: int = 4, count_lo: int = 2, count_hi: int = 64,
                  pareto_a: float = 1.5):
    """Long-tail per-entity datasets. Fully vectorized generation: one draw for
    every record, then per-entity slices exposed as padded blocks (the
    partitioner's fast representation)."""
    rng = np.random.RandomState(seed)
    counts = np.clip((rng.pareto(pareto_a, num_entities) * 8
                      + count_lo).astype(int), count_lo, count_hi)
    total = int(counts.sum())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx_all = rng.randint(0, d, size=(total, max_nnz)).astype(np.int32)
    val_all = rng.randn(total, max_nnz)
    nnz_all = rng.randint(1, max_nnz + 1, size=total).astype(np.int32)
    mask = np.arange(max_nnz)[None, :] < nnz_all[:, None]
    val_all = val_all * mask
    w_true = np.repeat(rng.randn(num_entities), counts)
    z = val_all.sum(1) * 0.5 + w_true
    y_all = (rng.rand(total) < 1 / (1 + np.exp(-z))).astype(np.float64)
    off_all = 0.1 * rng.randn(total)
    uid_all = np.arange(total, dtype=np.int64)
    groups = []
    for e in range(num_entities):
        s0, n = int(starts[e]), int(counts[e])
        sl = slice(s0, s0 + n)
        groups.append(EntityGroup(
            entity_id=str(e),
            columns={"uid": uid_all[sl], "response": y_all[sl],
                     "offset": off_all[sl]},
            padded_indices=idx_all[sl], padded_values=val_all[sl],
            rec_nnz=nnz_all[sl]))
    return groups


SOLVER = os.environ.get("BENCH_SOLVER", "newton")
PHASE1 = int(os.environ.get("BENCH_PHASE1", 0))

# exactly the production solver path (module-level cached jits from the RE model)
_KEY = dict(has_intercept=True, regularize_bias=False, lam=1.0,
            ftol=1e-12, pgtol=1e-5, m=10, variance_mode=None)


def _solver(u_cap, maxiter, batch_elems=0, n_cap=0, batch_b=0):
    from gdmix_tpu.models.random_effect_lr import (_lbfgs_dense_solver,
                                                   _newton_dual_solver)
    key = (u_cap, _KEY["has_intercept"], _KEY["regularize_bias"], _KEY["lam"],
           maxiter, _KEY["ftol"], _KEY["pgtol"], _KEY["m"],
           _KEY["variance_mode"])
    # mirror REParams.batch_solver="auto": Newton–Cholesky up to
    # newton_max_dim=128, sample-space (dual) Newton for wide buckets with
    # n_cap < dim, dense-X L-BFGS beyond when the bucket fits, sparse
    # vmapped L-BFGS as the last resort
    dim = u_cap + 1
    if SOLVER == "newton" and dim <= 128:
        return _newton_solver(*key)
    if SOLVER != "lbfgs" and 0 < n_cap < dim \
            and batch_b * n_cap * n_cap <= 200_000_000 \
            and batch_elems <= 200_000_000:
        return _newton_dual_solver(*key)
    if batch_elems <= 200_000_000:
        return _lbfgs_dense_solver(*key)
    return _lbfgs_solver(*key)


def bucket_solver(u_cap, shape_b, shape_n, maxiter=100):
    """The production jitted solver for a bucket of this shape: the device-
    side two-phase compaction when PHASE1 > 0 applies, else the ladder."""
    if PHASE1 and SOLVER == "newton" and u_cap + 1 <= 128 and shape_b > 64:
        from gdmix_tpu.models.random_effect_lr import _newton_two_phase_solver
        key = (u_cap, _KEY["has_intercept"], _KEY["regularize_bias"],
               _KEY["lam"], maxiter, _KEY["ftol"], _KEY["pgtol"], _KEY["m"],
               _KEY["variance_mode"], PHASE1)
        return _newton_two_phase_solver(*key)
    elems = shape_b * shape_n * (u_cap + 1)
    return _solver(u_cap, maxiter, elems, n_cap=shape_n, batch_b=shape_b)


def solve_two_phase(u_cap, arrays_np, dt, maxiter=100, arrays_dev=None):
    """Production solve: single-phase Newton, or (PHASE1 > 0) the device-side
    two-phase straggler compaction — one dispatch, no host round-trip
    (random_effect_lr._newton_two_phase_solver)."""
    a = arrays_dev if arrays_dev is not None else {
        k: (jnp.asarray(v) if k == "indices" else jnp.asarray(v, dt))
        for k, v in arrays_np.items()}
    out = bucket_solver(u_cap, a["indices"].shape[0], a["indices"].shape[1],
                        maxiter)(a)
    # defer the sync to the caller (pipelined dispatch across buckets)
    return out[0], out[2]


# Fusing every bucket's solve into ONE jit (single dispatch per rep) measured
# a wash on an earlier accelerator: async dispatch already pipelines the
# buckets. Not measured on the H100.


def run_re(groups, tag: str, reps: int) -> float:
    """Time the production bucketed solve over `groups`; returns models/sec."""
    t_setup = time.time()
    # batch_align=8 (the production fit_groups default): padding a tier's
    # batch to a 256 floor costs up to 4× wasted rows on the sparse big-n
    # tiers of a heavy tail (the pow-2 rounding alone bounds waste at 2×)
    buckets = bucketize(groups, _Schema, "offset", has_intercept=True,
                        batch_align=8)
    setup_s = time.time() - t_setup

    dt = jnp.float32
    np_buckets = []
    for b in buckets:
        arrays_np = dict(
            theta0=b.theta0.astype(np.float32), indices=b.indices,
            values=b.values.astype(np.float32),
            offsets=b.offsets.astype(np.float32),
            labels=b.labels.astype(np.float32),
            weights=b.weights.astype(np.float32),
            sample_count=b.sample_count.astype(np.float32))
        arrays_dev = {k: (jnp.asarray(v) if k == "indices"
                          else jnp.asarray(v, dt))
                      for k, v in arrays_np.items()}
        np_buckets.append((b, arrays_np, arrays_dev))

    # Warm up (compile every bucket shape incl. likely phase-2 tiers).
    for b, arrays_np, arrays_dev in np_buckets:
        out = solve_two_phase(b.u_cap, arrays_np, dt, arrays_dev=arrays_dev)
        float(jnp.sum(out[0]))

    # Timed reps: perturb the warm start each rep so no layer can reuse
    # results; host checksum fetches are the sync (dispatch is pipelined
    # across buckets in the single-phase path).
    rep_times = []
    results = None
    for rep in range(reps):
        eps = jnp.asarray(1e-6 * (rep + 1), dt)
        t0 = time.time()
        results = []
        for b, arrays_np, arrays_dev in np_buckets:
            dev = dict(arrays_dev, theta0=arrays_dev["theta0"] + eps)
            results.append(solve_two_phase(b.u_cap, arrays_np, dt,
                                           arrays_dev=dev))
        for th, c in results:
            float(jnp.sum(th) + jnp.sum(c))
        rep_times.append(time.time() - t0)
    # min over reps: the least-noise estimator under dispatch jitter
    elapsed = min(rep_times)

    n_models = sum(len(b.entity_ids) for b in buckets)
    converged = float(np.mean([np.asarray(c)[:len(b.entity_ids)].mean()
                               for (x, c), (b, _, _) in zip(results,
                                                           np_buckets)]))
    models_per_sec = n_models / elapsed
    u_max = max(b.u_cap for b in buckets)
    sys.stderr.write(
        f"bench[{tag}]: {n_models} models in {elapsed:.3f}s (reps "
        f"{[round(t, 3) for t in rep_times]}) on {jax.devices()[0]} "
        f"({len(buckets)} buckets, u_cap<= {u_max}, setup {setup_s:.1f}s, "
        f"converged {converged:.3f})\n")
    return models_per_sec


def make_workload_flat(num_entities: int, seed: int = 0, d: int = 24,
                       max_nnz: int = 4, count_lo: int = 2,
                       count_hi: int = 64, pareto_a: float = 1.5):
    """make_workload as a columnar FlatGroups (the production host path) —
    same draws, zero per-entity objects."""
    from gdmix_tpu.data.bucketing import FlatGroups
    rng = np.random.RandomState(seed)
    counts = np.clip((rng.pareto(pareto_a, num_entities) * 8
                      + count_lo).astype(int), count_lo, count_hi)
    total = int(counts.sum())
    idx_all = rng.randint(0, d, size=(total, max_nnz)).astype(np.int32)
    val_all = rng.randn(total, max_nnz)
    nnz_all = rng.randint(1, max_nnz + 1, size=total).astype(np.int32)
    mask = np.arange(max_nnz)[None, :] < nnz_all[:, None]
    val_all = val_all * mask
    w_true = np.repeat(rng.randn(num_entities), counts)
    z = val_all.sum(1) * 0.5 + w_true
    y_all = (rng.rand(total) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return FlatGroups(
        entity_ids=np.array([str(e) for e in range(num_entities)], object),
        counts=counts.astype(np.int64),
        columns={"uid": np.arange(total, dtype=np.int64), "response": y_all,
                 "offset": 0.1 * rng.randn(total)},
        indices=idx_all, values=val_all, rec_nnz=nnz_all)


def _stage_model(d: int, tmp: str):
    """The production RandomEffectLRModel over a synthetic d-wide feature bag
    (metadata + feature list written under tmp)."""
    from gdmix_tpu.io.feature_list import write_feature_list
    from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu.params import Params, REParams

    md_file = os.path.join(tmp, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "per_entity", "dtype": "float", "shape": [d],
             "isSparse": True},
            {"name": "user_id", "dtype": "string", "shape": [],
             "isSparse": False},
            {"name": "uid", "dtype": "long", "shape": [],
             "isSparse": False},
            {"name": "offset", "dtype": "float", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "float",
                        "shape": [], "isSparse": False}]}, f)
    feature_file = os.path.join(tmp, "features.csv")
    write_feature_list([(f"f{i}", "") for i in range(d)], feature_file)
    model_params = REParams(
        metadata_file=md_file, output_model_dir=tmp,
        feature_bag="per_entity", feature_file=feature_file,
        partition_entity="user_id", l2_reg_weight=1.0,
        regularize_bias=False, dtype="float32", lbfgs_tolerance=1e-12,
        lbfgs_pgtol=1e-5, num_of_lbfgs_iterations=100,
        sparsity_threshold=1e-4,
        re_mode=os.environ.get("BENCH_RE_MODE", "auto"))
    base_params = Params(
        action="train", stage="random_effect",
        model_type="logistic_regression", label_column_name="response",
        uid_column_name="uid",
        prediction_score_column_name="predictionScore")
    return RandomEffectLRModel(model_params, base_params), base_params


def run_re_stage(fg, reps: int) -> float:
    """End-to-end RE STAGE rate through the production class: fit_flat (the
    exact dispatch RandomEffectLRModel.train runs — re_mode=auto takes the
    sharded device plane: host support/local-index prep + routing + on-device
    per-tier grouping + cached solves + ModelTable collection) + photon-ml
    avro export + model reload — everything the reference's random-effect
    trainer does per partition except file-dataset decode
    (random_effect_lr_lbfgs_model.py:92-138). models/sec including host work."""
    import shutil
    import tempfile

    d = int(fg.indices.max()) + 1
    tmp = tempfile.mkdtemp(prefix="gdx_bench_stage_")
    try:
        model, base_params = _stage_model(d, tmp)
        model_file = os.path.join(tmp, "part-00000.avro")

        rep_times = []
        n_loaded = 0
        for rep in range(max(reps, 2)):  # rep 0 = compile warm-up
            t0 = time.time()
            weights = model.fit_flat(fg, {}, base_params)
            model._save_model(model_file, weights)
            loaded = model._load_weights(model_file)
            n_loaded = len(loaded)
            rep_times.append(time.time() - t0)
        elapsed = min(rep_times[1:])
        # snapshot the COLD fit's wire accounting BEFORE the warm loop
        # resets it (fit_groups zeroes the counters at every fit)
        cold_bytes_up = int(getattr(model, "last_fit_bytes_up", 0))
        cold_bytes_down = int(getattr(model, "last_fit_bytes_down", 0))
        cold_phases = dict(getattr(model, "last_fit_phases", {}))
        cold_plane = getattr(model, "last_fit_plane", "host")
        # solve-bound rate by MEASUREMENT, not modeling: the device-cache
        # warm path re-ships only offsets/warm starts (~3% of the wire), so
        # a cached fit's wall IS the solve+marshal term
        dev_cache = {}
        warm_times = []
        for rep in range(3):   # rep 0 populates the cache
            t0 = time.time()
            model.fit_flat(fg, weights, base_params, device_cache=dev_cache)
            warm_times.append(time.time() - t0)
        warm_s = min(warm_times[1:])
        sys.stderr.write(f"bench[re-stage]: warm cached fit "
                         f"{[round(t, 3) for t in warm_times]}\n")
        n_models = len(fg)
        assert n_loaded == n_models, (n_loaded, n_models)
        sys.stderr.write(
            f"bench[re-stage]: {n_models} models fit+export+reload in "
            f"{elapsed:.3f}s (reps {[round(t, 3) for t in rep_times]})\n")
        decomp = dict(
            wall_s=round(elapsed, 4),
            warm_fit_s=round(warm_s, 4),
            plane=cold_plane,
            bytes_up=cold_bytes_up,
            bytes_down=cold_bytes_down,
            phases={k: round(v, 4) for k, v in cold_phases.items()})
        return n_models / elapsed, n_models / warm_s, decomp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_re_score(fg, num_records: int, reps: int) -> float:
    """Records scored per second through the production sparse-CSR scorer
    (score_records: host entity join + rank-compaction + device binary-search
    join + fetch) — the in-HBM pipeline's per-coordinate scoring path, now
    O(nnz) in memory at any (E, D) (round 4 replaced the dense [E+1, D]
    table). Entities are the fitted models of a stage-shaped workload; ~3%
    of records reference unmodeled entities (logits = offsets parity,
    reference job_consumers.py:144-152)."""
    import shutil
    import tempfile
    from gdmix_tpu.io.input_pipeline import PerRecordData

    d = int(fg.indices.max()) + 1
    tmp = tempfile.mkdtemp(prefix="gdx_bench_score_")
    try:
        model, base_params = _stage_model(d, tmp)
        weights = model.fit_flat(fg, {}, base_params)

        rng = np.random.RandomState(7)
        E = len(fg)
        k = fg.indices.shape[1]
        ent = rng.randint(0, int(E * 1.03), num_records)
        data = PerRecordData(
            columns={"user_id": np.array([str(e) for e in ent], object),
                     "uid": np.arange(num_records, dtype=np.int64),
                     "offset": 0.1 * rng.randn(num_records)},
            indices=rng.randint(0, d, (num_records, k)).astype(np.int32),
            values=rng.randn(num_records, k),
            nnz=np.full(num_records, k, np.int64),
            num_samples=num_records)

        times = []
        for _ in range(max(reps, 2)):   # rep 0 = compile warm-up
            t0 = time.time()
            out = model.score_records(data, weights, base_params)
            assert len(out["total"]) == num_records
            times.append(time.time() - t0)
        elapsed = min(times[1:])
        sys.stderr.write(
            f"bench[re-score]: {num_records} records x {E} models in "
            f"{elapsed:.3f}s (reps {[round(t, 3) for t in times]})\n")
        return num_records / elapsed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_detext(reps: int) -> float:
    """Deep-tower (DeText-style) training-step rate through the production
    module (models/deep_tower._TextWideTower, cnn encoder) — rows/sec of the
    jitted Adam step at B=4096, L=16, vocab=30k, 64-dim units, wide D=10k.
    The flagship deep fixed effect's hardware number (the reference
    delegates this tower to the external DeText package on CPU workers)."""
    import optax
    from gdmix_tpu.models.deep_tower import _TextWideTower
    from gdmix_tpu.ops.logistic import stable_bce

    B, L, V, D, K = 4096, 16, 30_000, 10_000, 8
    tower = _TextWideTower(vocab_size=V, num_wide=D, num_units=64,
                           windows=(2, 3), num_filters=64, num_hidden=128,
                           ftr_ext="cnn")

    @jax.jit
    def gen(key):
        ks = jax.random.split(key, 5)
        return (jax.random.randint(ks[0], (B, 1, L), 0, V, jnp.int32),
                (jax.random.uniform(ks[1], (B, 1, L)) < 0.9)
                .astype(jnp.float32),
                jax.random.randint(ks[2], (B, K), 0, D, jnp.int32),
                jax.random.normal(ks[3], (B, K), jnp.float32),
                jax.random.bernoulli(ks[4], 0.5, (B,)).astype(jnp.float32))

    tokens, mask, widx, wval, labels = gen(jax.random.PRNGKey(0))
    float(jnp.sum(wval))
    params = tower.init(jax.random.PRNGKey(1), tokens, mask, widx, wval)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, tokens, mask, widx, wval, labels):
        def loss_fn(prm):
            logits = tower.apply(prm, tokens, mask, widx, wval)
            return jnp.mean(stable_bce(logits, labels))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state, loss = step(params, opt_state, tokens, mask, widx,
                                   wval, labels)
    float(loss)   # compile + first step
    times = []
    for _ in range(max(reps, 2)):
        t0 = time.time()
        params, opt_state, loss = step(params, opt_state, tokens, mask,
                                       widx, wval, labels)
        float(loss)
        times.append(time.time() - t0)
    elapsed = min(times)
    sys.stderr.write(f"bench[detext]: step {elapsed*1e3:.1f}ms at B={B} "
                     f"(reps {[round(t, 4) for t in times]})\n")
    return B / elapsed


def run_re_sharded(fg, tag: str, reps: int) -> float:
    """models/sec through the sharded device plane alone (fit_flat →
    fit_records_sharded): the multi-chip production path, timed fit-only —
    the sharded counterpart of run_re's host-bucket solve metric."""
    import shutil
    import tempfile

    d = int(fg.indices.max()) + 1
    tmp = tempfile.mkdtemp(prefix="gdx_bench_shard_")
    try:
        model, base_params = _stage_model(d, tmp)
        # force the sharded plane: re_mode=auto falls back to the host plane
        # on a 1-device mesh (nothing to route), which would silently turn
        # this sub-metric into a second host-plane measurement
        model.model_params.re_mode = "sharded"
        rep_times = []
        for rep in range(max(reps, 2)):  # rep 0 = compile warm-up
            t0 = time.time()
            weights = model.fit_flat(fg, {}, base_params)
            n_models = len(weights)
            rep_times.append(time.time() - t0)
        elapsed = min(rep_times[1:])
        assert n_models == len(fg), (n_models, len(fg))
        sys.stderr.write(
            f"bench[{tag}]: {n_models} models via the sharded plane in "
            f"{elapsed:.3f}s (reps {[round(t, 3) for t in rep_times]})\n")
        return n_models / elapsed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_fe(reps: int = 4, d: int = 10_000, tag: str = "fe",
           zipf_s: float = 0.0) -> float:
    """Fixed-effect loss+grad funcalls/sec at N=5M, D=10k, K=16 THROUGH THE
    PRODUCTION CLASS: the timed objective is FixedEffectLRModel's own
    _objective_fun — the exact (value, grad) every fit_data L-BFGS funcall
    evaluates — so the model's grad_mode=auto resolution (block here), chunk
    padding, precision table and L2 wiring are all on the measured path; a
    regression in any of them moves this number. Data is generated on device
    (the 640MB host->device upload is not part of the funcall rate)."""
    import shutil
    import tempfile
    from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu.ops.logistic import SparseBatch
    from gdmix_tpu.params import FixedLRParams, Params
    n = int(os.environ.get("BENCH_FE_N", 4_997_120))  # CPU smoke: set small
    k = 16

    tmp = tempfile.mkdtemp(prefix="gdx_bench_fe_")
    try:
        md_file = os.path.join(tmp, "tensor_metadata.json")
        with open(md_file, "w") as f:
            json.dump({"features": [
                {"name": "global", "dtype": "float", "shape": [d],
                 "isSparse": True},
                {"name": "uid", "dtype": "long", "shape": [],
                 "isSparse": False},
                {"name": "offset", "dtype": "float", "shape": [],
                 "isSparse": False}],
                "labels": [{"name": "response", "dtype": "float",
                            "shape": [], "isSparse": False}]}, f)
        model_params = FixedLRParams(
            metadata_file=md_file, output_model_dir=tmp, feature_bag="global",
            l2_reg_weight=1.0, regularize_bias=False, dtype="float32")
        base_params = Params(
            action="train", stage="fixed_effect",
            model_type="logistic_regression", label_column_name="response",
            uid_column_name="uid",
            prediction_score_column_name="predictionScore")
        model = FixedEffectLRModel(model_params, base_params)

        @jax.jit
        def gen(key):
            k1, k2, k3, k4 = jax.random.split(key, 4)
            u = jax.random.uniform(k1, (n, k), jnp.float32, 1e-7, 1.0)
            if zipf_s == 0.0:
                idx = jax.random.randint(k1, (n, k), 0, d, jnp.int32)
            elif zipf_s == 1.0:
                idx = jnp.clip(jnp.exp(u * jnp.log(float(d)))
                               .astype(jnp.int32) - 1, 0, d - 1)
            else:
                # inverse-CDF Zipf(s) on [1, d] — recommender id features
                # are power-law; s=1.2 is the movie/item-popularity class
                a = 1.0 - zipf_s
                idx = jnp.clip(((1.0 + u * (float(d) ** a - 1.0))
                                ** (1.0 / a)).astype(jnp.int32) - 1, 0, d - 1)
            return SparseBatch(
                idx,
                jax.random.normal(k2, (n, k), jnp.float32),
                0.1 * jax.random.normal(k4, (n,), jnp.float32),
                jax.random.bernoulli(k3, 0.5, (n,)).astype(jnp.float32),
                jnp.ones((n,), jnp.float32))

        batch = gen(jax.random.PRNGKey(0))
        float(jnp.sum(batch.values))
        # hybrid aux through the model API (auto resolves to hybrid past
        # block's ceiling; on uniform ids the builder DECLINES and the
        # objective degrades to scatter — both paths are production)
        t0 = time.time()
        aux = model.build_hybrid_aux_for(batch)
        if aux is not None:
            int(aux.cold_idx[0])  # scalar fetch = sync
            sys.stderr.write(
                f"bench[{tag}]: hybrid aux built in {time.time() - t0:.1f}s "
                f"(A={aux.hot_ids.shape[0]}, "
                f"mc_pad={aux.cold_idx.shape[0]})\n")

        # the batch rides as a jit ARGUMENT (closing over it would embed
        # 640MB of constants in the compiled program)
        @jax.jit
        def fun(x, b, ax):
            return model._objective_fun(b, ax)(x)

        x = jnp.zeros((model._dim,), jnp.float32)
        v, g = fun(x, batch, aux)
        float(v)  # compile + first call
        times = []
        for _ in range(reps):
            x = x - 1e-4 * g
            t0 = time.time()
            v, g = fun(x, batch, aux)
            float(v), float(jnp.sum(g))  # host fetch = sync
            times.append(time.time() - t0)
        sys.stderr.write(f"bench[{tag}]: funcall min={min(times):.4f}s "
                         f"(earlier one-hot {FE_ROUND1_FUNCALL_S}s)\n")
        return 1.0 / min(times)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _require_devices(timeout_s: float):
    """Fail fast (stderr + exit 2, no JSON) when device init hangs instead of
    blocking the bench forever."""
    import threading
    out = {}

    def probe():
        try:
            out["devices"] = jax.devices()
        except Exception as e:   # pragma: no cover - backend-specific
            out["error"] = repr(e)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if "devices" in out:
        print(f"bench: devices {out['devices']}", file=sys.stderr)
        return
    print(f"bench: device init {'failed: ' + out['error'] if 'error' in out else f'timed out after {timeout_s:.0f}s'} "
          f"— no measurement taken", file=sys.stderr)
    sys.exit(2)


_EMITTED = False


def _emit(primary, submetrics, partial=False):
    """Print THE one JSON line. Idempotent: the watchdog and the normal path
    may race; first wins."""
    global _EMITTED
    if _EMITTED:
        return
    _EMITTED = True
    if partial:
        sys.stderr.write("bench: BUDGET EXPIRED — emitting completed "
                         f"submetrics only ({sorted(submetrics)})\n")
    print(json.dumps({
        "metric": "random_effect_models_per_sec_per_chip",
        "value": round(primary, 1),
        "unit": "models/sec",
        "vs_baseline": round(primary / TARGET_MODELS_PER_SEC, 3),
        "submetrics": submetrics,
    }), flush=True)


def main():
    _require_devices(float(os.environ.get("BENCH_DEVICE_TIMEOUT", 900)))
    reps = int(os.environ.get("BENCH_REPS", 5))
    primary = run_re(make_workload(NUM_ENTITIES), "movielens", reps)
    submetrics = {}

    # Watchdog: a stalled SUBMETRIC must not cost the whole measurement —
    # once the primary exists, guarantee the JSON line. A timer thread is the
    # only shape that works here: the main thread blocks inside the PJRT
    # client during a compile, so signal handlers would be deferred until the
    # very call we need to escape returns.
    import threading
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 1500))
    t_start = time.time()

    def _watchdog():
        _emit(primary, dict(submetrics), partial=True)
        os._exit(0)

    watchdog = threading.Timer(budget_s, _watchdog)
    watchdog.daemon = True
    if budget_s > 0:
        watchdog.start()
    if HEAVY_ENTITIES:
        heavy = make_workload(HEAVY_ENTITIES, seed=1, count_hi=2048,
                              pareto_a=1.2)
        submetrics["re_heavy_tail_models_per_sec"] = round(
            run_re(heavy, "heavy-tail", max(reps - 2, 1)), 1)
    if WIDE_ENTITIES:
        wide = make_workload(WIDE_ENTITIES, seed=2, d=512, max_nnz=16,
                             count_lo=32, count_hi=64)
        submetrics["re_wide_support_models_per_sec"] = round(
            run_re(wide, "wide-support", max(reps - 2, 1)), 1)
    if STAGE_ENTITIES:
        up_bw, down_bw, dispatch_lat = probe_link()
        submetrics["dispatch_latency_ms"] = round(dispatch_lat * 1e3, 2)
        submetrics["link_up_mb_per_s"] = round(up_bw / 1e6, 1)
        stage_rate, warm_rate, decomp = run_re_stage(
            make_workload_flat(STAGE_ENTITIES, seed=3), max(reps - 2, 2))
        submetrics["re_stage_models_per_sec"] = round(stage_rate, 1)
        # decomposition: the solve-bound rate is MEASURED (warm cached fit —
        # offsets-only wire), not modeled; serial-link seconds are reported
        # alongside so the
        # link-bound fraction is explicit (they can exceed the wall — the
        # async uploads overlap each other and the solve)
        link_s = decomp["bytes_up"] / up_bw + decomp["bytes_down"] / down_bw
        decomp["serial_link_s_est"] = round(link_s, 4)
        decomp["link_fraction"] = round(
            min(link_s / decomp["wall_s"], 1.0), 3)
        submetrics["re_stage_decomposition"] = decomp
        submetrics["re_stage_solve_bound_models_per_sec"] = round(
            warm_rate, 1)
    if os.environ.get("BENCH_DETEXT", "1") != "0":
        submetrics["detext_rows_per_sec"] = round(
            run_detext(max(reps - 2, 2)), 1)
    score_records = int(os.environ.get("BENCH_SCORE_RECORDS", 1_000_000))
    if STAGE_ENTITIES and score_records:
        submetrics["re_score_records_per_sec"] = round(
            run_re_score(make_workload_flat(STAGE_ENTITIES, seed=3),
                         score_records, max(reps - 2, 2)), 1)
    if HEAVY_ENTITIES:
        heavy_fg = make_workload_flat(HEAVY_ENTITIES, seed=1, count_hi=2048,
                                      pareto_a=1.2)
        submetrics["re_sharded_heavy_tail_models_per_sec"] = round(
            run_re_sharded(heavy_fg, "sharded-heavy-tail",
                           max(reps - 2, 1)), 1)
    if RUN_FE:
        fe_rate = run_fe()
        submetrics["fe_funcalls_per_sec"] = round(fe_rate, 2)
        submetrics["fe_speedup_vs_round1"] = round(
            fe_rate * FE_ROUND1_FUNCALL_S, 2)
    if RUN_FE and os.environ.get("BENCH_FE_WIDE", "1") != "0":
        # wide-D regime: D=1M is past block's ~700k ceiling, so auto
        # resolves to the hot/cold HYBRID. Recommender id features are
        # power-law — Zipf s=1.2 (item-popularity class) is the
        # representative workload
        submetrics["fe_wide_d_funcalls_per_sec"] = round(
            run_fe(max(reps - 2, 2), d=1_000_000, tag="fe-wide-d",
                   zipf_s=1.2), 2)
        # uniform ids have NO hot set: the builder declines and the same
        # auto path degrades to the scatter objective — this pins the
        # fallback
        submetrics["fe_wide_d_uniform_funcalls_per_sec"] = round(
            run_fe(max(reps - 2, 2), d=1_000_000, tag="fe-wide-d-uniform"),
            2)
    watchdog.cancel()
    sys.stderr.write(f"bench: total wall {time.time() - t_start:.0f}s\n")
    _emit(primary, submetrics)


if __name__ == "__main__":
    main()
