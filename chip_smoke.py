#!/usr/bin/env python
"""Smoke run of the GLMix main path on NVIDIA GPUs, through the entry points a
user calls, at the widths the repo's bench runs.

    python chip_smoke.py             # one card (the first): every phase below
    python chip_smoke.py --chips 4   # four cards: the multi-card path only
    python chip_smoke.py --chips 4 --phase fe-mesh   # one phase of the set

One card:
  precision  what Precision.DEFAULT / HIGH / HIGHEST give for a float32 dot
  fe-10k     FixedEffectLRModel._objective_fun (grad_mode=auto -> block) at
             N=4,997,120, D=10,000, K=16 vs a float64 NumPy gather/scatter
             reference
  fe-1m      the same at D=1,000,000 on Zipf-1.2 ids (auto -> hybrid), plus
             the hybrid's cold side (XLA gather + scatter-add) timed alone
  fe-fit     fit_data on the D=10k batch: the loss after 1, 5, 10 and 20
             L-BFGS iterations must fall monotonically
  re-primary 100,000 entities, d=24 (bench.py's primary mix) through bucketize
             + the production _newton_solver: every entity converges, and 256
             sampled entities match a float64 per-entity Newton oracle
  re-heavy   the same on the heavy-tail mix (20,000 entities, 2..2048 records)
  pipeline   the in-memory pipeline (what `workflow.main --mode in_memory`
             runs), 2 sweeps of global FE -> per-user RE -> per-movie RE on a
             MovieLens-1M-shaped synthetic set: sweep 1's validation AUC must
             climb coordinate by coordinate, and sweep 2 must not lose it

Four cards (--chips 4): the FE objective and fit on a 4-card data-parallel
mesh vs one card (errors, collectives, per-funcall time), the sharded RE plane
(fit_records_sharded) on 4 cards vs the host plane on one card on the
heavy-tail mix, in float32 and in float64, the pipeline on the 4-card mesh,
and each card's bytes in use.

Times printed here are smoke numbers from a single run (first call, which
compiles, shown apart from one steady-state call); they are not benchmark
metrics. Every comparison prints its error beside its tolerance. The last
line is one JSON object {"ok": true, "device": {...}}; any failed check or
error exits nonzero without it. JAX must find a GPU: there is no CPU fallback.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

FE_N = 4_997_120          # 610 block chunks of 8192 records
FE_K = 16
FE_D = 10_000             # grad_mode=auto -> block
FE_D_WIDE = 1_000_000     # past block's ceiling: auto -> hybrid
FE_L2 = 1.0
FE_OBJ_RTOL = 1e-5        # float32 with float32-accurate products
FE_GRAD_RTOL = 1e-4
FE_FIT_ITERS = (1, 5, 10, 20)
FE_MESH_RTOL = 1e-4
RE_L2 = 1.0
RE_PRIMARY_ENTITIES = 100_000
RE_HEAVY_ENTITIES = 20_000
RE_ORACLE_SAMPLE = 256
RE_ORACLE_ATOL = 1e-3
RE_SHARDED_ATOL = 1e-4
RE_F64_PGTOL = 1e-10
# the reference's scipy stopping rule the production solver keys on
RE_SOLVER_KEY = dict(has_intercept=True, regularize_bias=False, lam=RE_L2,
                     maxiter=100, ftol=1e-12, pgtol=1e-5, m=10,
                     variance_mode=None)
ML1M = dict(num_users=6040, num_movies=3706, num_ratings=1_000_209)
PIPELINE_SWEEP_AUC_SLACK = 2e-3


# ----------------------------------------------------------- references ----
# Plain float64 NumPy re-implementations of the math, independent of the code
# under test (tests/test_chip_smoke.py checks them at tiny sizes on CPU).

def _sigmoid(z):
    return 0.5 * (1.0 + np.tanh(0.5 * z))


def fe_reference(x, indices, values, offsets, labels, weights, l2,
                 model_type="logistic_regression"):
    """Float64 fixed-effect objective and gradient by plain gather and
    scatter: Σ w·loss(z) + λ/2·‖w‖², z = Σ_k v·θ[idx] + offset + b, with the
    intercept b LAST in x and unregularized; loss is the stable BCE, or
    (y − z)² for linear regression."""
    x = np.asarray(x, np.float64)
    w, b = x[:-1], x[-1]
    vals = np.asarray(values, np.float64)
    z = np.einsum("nk,nk->n", vals, w[indices]) \
        + np.asarray(offsets, np.float64) + b
    y = np.asarray(labels, np.float64)
    wt = np.asarray(weights, np.float64)
    if model_type == "linear_regression":
        per, dz = (y - z) ** 2, 2.0 * (z - y)
    else:
        per = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
        dz = _sigmoid(z) - y
    value = float(np.dot(wt, per) + 0.5 * l2 * np.dot(w, w))
    r = wt * dz
    gw = np.bincount(np.asarray(indices).ravel(),
                     weights=(vals * r[:, None]).ravel(),
                     minlength=len(w))
    return value, np.concatenate([gw + l2 * w, [r.sum()]])


def re_objective(X, y, weights, offsets, l2, theta):
    """Float64 mean-form objective of one entity, with its gradient and
    Hessian: (Σ w·bce(Xθ + offset) + λ/2·Σ_{j≥1} θ_j²)/n, intercept in column
    0 and unregularized (reference binary_logistic_regression.py:84-131)."""
    X = np.asarray(X, np.float64)
    n, d = X.shape
    mask = np.ones(d)
    mask[0] = 0.0
    z = X @ theta + offsets
    bce = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
    p = _sigmoid(z)
    f = (np.dot(weights, bce) + 0.5 * l2 * np.dot(mask * theta, theta)) / n
    g = (X.T @ (weights * (p - y)) + l2 * mask * theta) / n
    H = (X.T @ (X * (weights * p * (1 - p))[:, None]) + l2 * np.diag(mask)) / n
    return f, g, H


def re_newton_oracle(X, y, weights, offsets, l2, gtol=1e-10, maxiter=200):
    """Float64 damped Newton on one entity's re_objective."""
    theta = np.zeros(np.shape(X)[1])
    for _ in range(maxiter):
        f0, g, H = re_objective(X, y, weights, offsets, l2, theta)
        if np.max(np.abs(g)) <= gtol:
            break
        step = np.linalg.solve(H + 1e-12 * np.eye(len(theta)), g)
        a = 1.0
        while re_objective(X, y, weights, offsets, l2, theta - a * step)[0] \
                > f0 - 1e-4 * a * np.dot(g, step) and a > 1e-12:
            a *= 0.5
        theta = theta - a * step
    return theta


def re_entity_problem(fg, e):
    """Entity e of a FlatGroups fleet in float64: the design [n, 1 + d]
    (intercept column first), labels, offsets."""
    starts = np.concatenate([[0], np.cumsum(fg.counts)])
    d = int(fg.indices.max()) + 1
    sl = slice(starts[e], starts[e + 1])
    n = int(fg.counts[e])
    X = np.zeros((n, 1 + d))
    X[:, 0] = 1.0
    rows = np.repeat(np.arange(n), fg.indices.shape[1])
    np.add.at(X, (rows, 1 + fg.indices[sl].ravel()), fg.values[sl].ravel())
    return (X, fg.columns["response"][sl].astype(np.float64),
            np.asarray(fg.columns["offset"][sl], np.float64))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# -------------------------------------------------------------- harness ----

class Smoke:
    """Collects checks; prints each with its error and tolerance."""

    def __init__(self):
        self.failed = []

    def check(self, phase, what, err, tol):
        ok = bool(np.isfinite(err)) and err <= tol
        print(f"[{phase}] {what}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            self.failed.append(f"{phase}: {what}")

    def require(self, phase, what, cond):
        print(f"[{phase}] {what}: {'ok' if cond else 'FAILED'}", flush=True)
        if not cond:
            self.failed.append(f"{phase}: {what}")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, *args):
    """(first-call result, first-call s, steady-call s): the first call
    compiles; the second is one steady-state call."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def card_lines(count):
    """The cards' `name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()][:count]


def restrict_visible_cards(count):
    """Pin JAX to the first `count` cards before any backend starts, so a
    bigger host still yields exactly `count` devices."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([v for v in visible.split(",") if v.strip()] if visible
           else [str(i) for i in range(count)])
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:count])


# ------------------------------------------------------------------ FE ----

def _fe_model(tmp, d, mesh=None, **over):
    from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu.params import FixedLRParams, Params
    md_file = os.path.join(tmp, f"fe_metadata_{d}.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "global", "dtype": "float", "shape": [d],
             "isSparse": True},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "offset", "dtype": "float", "shape": [],
             "isSparse": False}],
            "labels": [{"name": "response", "dtype": "float", "shape": [],
                        "isSparse": False}]}, f)
    params = dict(metadata_file=md_file, output_model_dir=tmp,
                  feature_bag="global", l2_reg_weight=FE_L2,
                  regularize_bias=False, dtype="float32",
                  sparsity_threshold=0.0)
    params.update(over)
    base = Params(action="train", stage="fixed_effect",
                  model_type="logistic_regression",
                  label_column_name="response", uid_column_name="uid",
                  prediction_score_column_name="predictionScore")
    return FixedEffectLRModel(FixedLRParams(**params), base, mesh=mesh), base


def fe_batch(d, zipf_s, seed):
    """The bench's FE workload, generated on device: N×K ids (uniform, or
    inverse-CDF Zipf(s) on [1, d]), N(0,1) values, ±0.1 offsets, Bernoulli
    labels, unit weights."""
    import jax
    import jax.numpy as jnp
    from gdmix_tpu.ops.logistic import SparseBatch

    @jax.jit
    def gen(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        if zipf_s:
            u = jax.random.uniform(k1, (FE_N, FE_K), jnp.float32, 1e-7, 1.0)
            a = 1.0 - zipf_s
            idx = jnp.clip(((1.0 + u * (float(d) ** a - 1.0)) ** (1.0 / a))
                           .astype(jnp.int32) - 1, 0, d - 1)
        else:
            idx = jax.random.randint(k1, (FE_N, FE_K), 0, d, jnp.int32)
        return SparseBatch(
            idx, jax.random.normal(k2, (FE_N, FE_K), jnp.float32),
            0.1 * jax.random.normal(k4, (FE_N,), jnp.float32),
            jax.random.bernoulli(k3, 0.5, (FE_N,)).astype(jnp.float32),
            jnp.ones((FE_N,), jnp.float32))
    return jax.block_until_ready(gen(jax.random.PRNGKey(seed)))


def _host(batch):
    return [np.asarray(a) for a in batch]


def phase_precision(smoke):
    """What each lax.Precision gives for a float32 matmul on this backend:
    the compiled dot's configuration and its error against float64."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    a = rng.randn(1024, 1024).astype(np.float32)
    b = rng.randn(1024, 256).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        fn = jax.jit(lambda x, y, p=prec: jnp.matmul(x, y, precision=p))
        hlo = fn.lower(a, b).compile().as_text()
        dots = [ln.strip() for ln in hlo.splitlines()
                if re.search(r"custom-call|dot\(|__triton|__cublas", ln)]
        algos = sorted(set(re.findall(r'"algorithm":"(\w+)"', hlo)
                           + re.findall(r"algorithm=(\w+)", hlo)))
        out = np.asarray(fn(a, b), np.float64)
        errs[name] = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
        log("precision", f"{name}: max rel err {errs[name]:.3e}; "
            f"algorithm {algos or 'unset'}; "
            f"dot: {dots[0][:240] if dots else 'not found'}")
    smoke.check("precision", "HIGHEST float32 dot max rel err",
                errs["HIGHEST"], 1e-5)


def phase_fe_objective(smoke, tmp, d, zipf_s, tag):
    """grad_mode=auto objective through the model at a fixed θ vs the
    float64 reference. Returns (model, batch, aux, jitted objective, θ,
    reference gradient)."""
    import jax
    import jax.numpy as jnp
    from gdmix_tpu.models.fixed_effect_lr import effective_grad_mode
    model, _ = _fe_model(tmp, d)
    p = model.model_params
    mode = effective_grad_mode(p.grad_mode, d, p.block_min_features,
                               p.onehot_max_features, p.block_max_features)
    t0 = time.perf_counter()
    batch = fe_batch(d, zipf_s, seed=0 if d == FE_D else 1)
    log(tag, f"N={FE_N} D={d} K={FE_K} zipf={zipf_s or 'uniform'}: "
        f"grad_mode=auto -> {mode}; data generated on device in "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    aux = model.build_hybrid_aux_for(batch)
    if aux is not None:
        jax.block_until_ready(aux)
        log(tag, f"hybrid aux (set-up) {time.perf_counter() - t0:.2f}s: "
            f"A={aux.hot_ids.shape[0]} hot features, "
            f"{aux.cold_idx.shape[0]} cold entry slots")
    smoke.require(tag, f"auto resolves to {'hybrid' if zipf_s else 'block'}"
                  + (" with a hot set" if zipf_s else ""),
                  mode == ("hybrid" if zipf_s else "block")
                  and (aux is not None) == bool(zipf_s))

    @jax.jit
    def fun(x, b, ax):
        return model._objective_fun(b, ax)(x)

    x = jnp.asarray(0.05 * np.random.RandomState(3).randn(d + 1),
                    jnp.float32)
    (v, g), first, steady = timed(fun, x, batch, aux)
    log(tag, f"objective: first call {first:.2f}s, steady {steady:.4f}s "
        "per funcall (smoke timing)")
    t0 = time.perf_counter()
    v_ref, g_ref = fe_reference(np.asarray(x, np.float64), *_host(batch),
                                l2=FE_L2)
    log(tag, f"float64 NumPy reference in {time.perf_counter() - t0:.1f}s")
    smoke.check(tag, "objective rel err",
                abs(float(v) - v_ref) / abs(v_ref), FE_OBJ_RTOL)
    smoke.check(tag, "gradient rel L2 err", rel_l2(g, g_ref), FE_GRAD_RTOL)
    return model, batch, aux, fun, x, g_ref


def phase_fe_high(batch, d, x, g_ref):
    """The block objective with Precision.HIGH, at the fe-10k θ: reported,
    not required (the model maps block_precision="float32" to HIGHEST)."""
    import jax
    from gdmix_tpu.ops.logistic import fixed_effect_value_and_grad_block
    fn = jax.jit(lambda xx, bb: fixed_effect_value_and_grad_block(
        xx, bb, d, chunk=min(8192, FE_N), precision=jax.lax.Precision.HIGH))
    _, g = fn(x, batch)
    g = np.asarray(g, np.float64)
    g[:-1] += FE_L2 * np.asarray(x, np.float64)[:-1]
    log("fe-10k", f"block objective at Precision.HIGH: gradient rel L2 err "
        f"{rel_l2(g, g_ref):.3e} (reported only)")


def phase_fe_cold_side(batch, aux, x):
    """The hybrid's cold side alone — the XLA gather + scatter-add pair the
    removed windowed-scatter kernel replaced: seconds per funcall."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def cold(w, r, ax):
        zc = jnp.zeros(r.shape, w.dtype).at[ax.cold_row].add(
            jnp.take(w, ax.cold_idx) * ax.cold_val)
        gc = jnp.zeros(w.shape, w.dtype).at[ax.cold_idx].add(
            ax.cold_val * jnp.take(r, ax.cold_row))
        return zc, gc

    r = batch.offsets
    w = x[:-1]
    _, first, _ = timed(cold, w, r, aux)
    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(cold(w, r, aux))
        steady.append(time.perf_counter() - t0)
    live = int(np.sum(np.asarray(aux.cold_val) != 0))
    log("fe-1m", f"cold side alone: {live} cold entries "
        f"({aux.cold_idx.shape[0]} slots), first call {first:.2f}s, "
        f"steady median {np.median(steady):.4f}s per funcall "
        f"(min {min(steady):.4f}s; smoke timing)")


def _per_record(batch_host):
    from gdmix_tpu.io.input_pipeline import PerRecordData
    idx, val, off, lab, _ = batch_host
    n = len(lab)
    return PerRecordData(
        columns={"uid": np.arange(n, dtype=np.int64), "response": lab,
                 "offset": off},
        indices=idx, values=val, nnz=np.full(n, idx.shape[1], np.int64),
        num_samples=n)


def fe_fit(tmp, data, iters, mesh=None, device_cache=None, **over):
    """fit_data through a fresh model capped at `iters` L-BFGS iterations."""
    model, base = _fe_model(tmp, FE_D, mesh=mesh,
                            num_of_lbfgs_iterations=iters, **over)
    t0 = time.perf_counter()
    coef = model.fit_data(data, base, device_cache=device_cache)
    return np.asarray(coef, np.float64), time.perf_counter() - t0


def phase_fe_fit(smoke, tmp, batch, fun):
    """Loss after 1, 5, 10, 20 L-BFGS iterations of fit_data: a deterministic
    solve, so each run's end point is that iterate of the 20-iteration fit
    (or its earlier stopping point)."""
    import jax.numpy as jnp
    data = _per_record(_host(batch))
    cache = {}
    losses = [float(fun(jnp.zeros(FE_D + 1, jnp.float32), batch, None)[0])]
    for k in FE_FIT_ITERS:
        coef, wall = fe_fit(tmp, data, k, device_cache=cache)
        losses.append(float(fun(jnp.asarray(coef, jnp.float32), batch,
                                None)[0]))
        log("fe-fit", f"{k} iterations: loss {losses[-1]:.6f}, fit_data "
            f"{wall:.2f}s (includes compile; smoke timing)")
    # L-BFGS may stop early (ftol/pgtol): later budgets then end at the same
    # iterate, so the check is non-increasing with a net fall
    smoke.require("fe-fit", f"loss non-increasing over iterations "
                  f"0,{','.join(map(str, FE_FIT_ITERS))} and below its "
                  f"start: {losses}",
                  all(b <= a for a, b in zip(losses, losses[1:]))
                  and losses[-1] < losses[0])


# ------------------------------------------------------------------ RE ----

def re_workload(num_entities, seed, count_hi=64, pareto_a=1.5):
    """bench.py's per-entity fleet as columnar FlatGroups: d=24 features,
    1-4 nonzeros per record, 2..count_hi records per entity (Pareto)."""
    from bench import make_workload_flat
    return make_workload_flat(num_entities, seed=seed, count_hi=count_hi,
                              pareto_a=pareto_a)


class _Schema:
    uid_column_name = "uid"
    label_column_name = "response"
    weight_column_name = None
    prediction_score_column_name = "predictionScore"
    prediction_score_per_coordinate_column_name = \
        "predictionScorePerCoordinate"


def re_solve(fg, tag, device=None):
    """bucketize + the production cached Newton solver, bucket by bucket.
    Returns {entity id: dense [1 + d] θ}, all-converged flag."""
    import jax
    import jax.numpy as jnp
    from gdmix_tpu.data.bucketing import bucketize_flat
    from gdmix_tpu.models.random_effect_lr import _newton_solver
    from gdmix_tpu.ops.newton import densify_bucket, newton_lr_batch
    d = int(fg.indices.max()) + 1
    t0 = time.perf_counter()
    buckets = bucketize_flat(fg, _Schema, "offset", has_intercept=True)
    log(tag, f"{len(fg)} entities, {len(fg.columns['uid'])} records -> "
        f"{len(buckets)} buckets in {time.perf_counter() - t0:.2f}s (host)")
    k = RE_SOLVER_KEY

    @partial(jax.jit, static_argnums=1)
    def iterations(a, u_cap):
        X = densify_bucket(a["indices"], a["values"], u_cap, True)
        mask = jnp.ones((u_cap + 1,), X.dtype).at[0].set(0.0)
        return newton_lr_batch(a["theta0"], X, a["labels"], a["weights"],
                               a["offsets"], a["sample_count"],
                               l2_reg_weight=k["lam"], l2_mask=mask,
                               maxiter=k["maxiter"], ftol=k["ftol"],
                               pgtol=k["pgtol"]).num_iterations

    thetas, all_conv, solve_s = {}, True, 0.0
    tiers = {}      # (n_cap, u_cap) -> per-bucket rows of the log below
    for b in buckets:
        arrays = {name: np.asarray(getattr(b, name), np.float32)
                  for name in ("theta0", "values", "offsets", "labels",
                               "weights", "sample_count")}
        arrays["indices"] = b.indices
        a = jax.device_put(arrays, device)
        solver = _newton_solver(b.u_cap, k["has_intercept"],
                                k["regularize_bias"], k["lam"], k["maxiter"],
                                k["ftol"], k["pgtol"], k["m"],
                                k["variance_mode"])
        (theta, _, conv), first, steady = timed(solver, a)
        solve_s += steady
        iters = np.asarray(iterations(a, b.u_cap))[:b.batch]
        conv = np.asarray(conv)[:b.batch]
        all_conv &= bool(conv.all())
        tiers.setdefault((b.n_cap, b.u_cap), []).append(
            (b.indices.shape[0], b.batch, first, steady, iters, conv))
        theta = np.asarray(theta, np.float64)
        for lane, eid in enumerate(b.entity_ids):
            full = np.zeros(1 + d)
            full[0] = theta[lane, 0]
            u = int(b.u_count[lane])
            full[1 + b.unique_global_indices[lane, :u]] = \
                theta[lane, 1:1 + u]
            thetas[eid] = full
    for (n_cap, u_cap), rows in sorted(tiers.items()):
        iters = np.concatenate([r[4] for r in rows])
        log(tag, f"tier n_cap={n_cap} u_cap={u_cap}: {len(rows)} bucket(s) "
            f"of B={sorted({r[0] for r in rows})}, "
            f"{sum(r[1] for r in rows)} entities; first call (compile) "
            f"{max(r[2] for r in rows):.2f}s max, steady "
            f"{sum(r[3] for r in rows):.4f}s total; Newton iterations max "
            f"{iters.max()} mean {iters.mean():.2f}; converged "
            f"{np.concatenate([r[5] for r in rows]).mean():.4f}")
    log(tag, f"solve total {solve_s:.4f}s steady over {len(buckets)} "
        f"buckets (smoke timing; host bucketize excluded)")
    return thetas, all_conv


def phase_re(smoke, tag, fg):
    thetas, all_conv = re_solve(fg, tag)
    smoke.require(tag, f"all {len(fg)} entities converged", all_conv)
    re_oracle_check(smoke, tag, fg, thetas)


def re_oracle_check(smoke, tag, fg, thetas):
    """max |Δθ| of RE_ORACLE_SAMPLE sampled entities against the float64
    Newton oracle. Entities whose records carry one label class have no
    finite optimum in the unregularized intercept; the sample is drawn from
    the two-class ones."""
    two_class = np.nonzero(_two_class(fg))[0]
    rng = np.random.RandomState(11)
    sample = rng.choice(two_class, RE_ORACLE_SAMPLE, replace=False)
    worst = 0.0
    for e in sample:
        X, y, off = re_entity_problem(fg, e)
        want = re_newton_oracle(X, y, np.ones(len(y)), off, RE_L2)
        worst = max(worst, float(np.max(np.abs(
            thetas[fg.entity_ids[e]] - want))))
    smoke.check(tag, f"max |Δθ| vs float64 Newton oracle over "
                f"{RE_ORACLE_SAMPLE} sampled two-class entities",
                worst, RE_ORACLE_ATOL)


def _two_class(fg):
    """Per entity: do its records carry both label classes?"""
    pos = np.add.reduceat(fg.columns["response"], np.concatenate(
        [[0], np.cumsum(fg.counts)[:-1]]))
    return (pos > 0) & (pos < fg.counts)


# ------------------------------------------------------------ pipeline ----

def phase_pipeline(smoke, tmp, tag="pipeline"):
    from gdmix_tpu.data import movielens
    from gdmix_tpu.workflow.config import WorkflowConfig
    from gdmix_tpu.workflow.pipeline import InMemoryPipeline
    t0 = time.perf_counter()
    data = movielens.generate_synthetic(seed=7, **ML1M)
    ml = movielens.prepare_gdmix_data(os.path.join(tmp, "ml1m"), data)
    log(tag, f"MovieLens-1M-shaped data ({ML1M['num_users']} users, "
        f"{ML1M['num_movies']} movies, {ML1M['num_ratings']} ratings) "
        f"generated and written in {time.perf_counter() - t0:.1f}s (host)")
    gdmix_config = {"model_type": "logistic_regression",
                    "label_column_name": "response", "uid_column_name": "uid",
                    "prediction_score_column_name": "predictionScore",
                    "weight_column_name": "weight"}

    def coord(bag, extra=None):
        c = {"training_data_dir": os.path.join(ml, bag, "trainingData"),
             "validation_data_dir": os.path.join(ml, bag, "validationData"),
             "feature_file": os.path.join(ml, bag, "featureList", bag),
             "feature_bag": bag,
             "metadata_file": os.path.join(ml, bag, "metadata",
                                           "tensor_metadata.json"),
             "l2_reg_weight": 1.0, "regularize_bias": False,
             "lbfgs_tolerance": 1.0e-12, "num_of_lbfgs_iterations": 100,
             "num_of_lbfgs_curvature_pairs": 10,
             "gdmix_config": gdmix_config}
        c.update(extra or {})
        return c

    cfg = WorkflowConfig.from_dict({
        "output_dir": os.path.join(tmp, "ml1m-out"),
        "fixed_effect_config": {"global": coord("global")},
        "random_effect_config": {
            "per-user": coord("per_user", {"partition_entity": "user_id",
                                           "num_partitions": 1}),
            "per-movie": coord("per_movie", {"partition_entity": "movie_id",
                                             "num_partitions": 1})}})
    pipe = InMemoryPipeline(cfg, num_sweeps=2)
    t0 = time.perf_counter()
    pipe.run()
    log(tag, f"in-memory pipeline, 2 sweeps: {time.perf_counter() - t0:.1f}s "
        "wall including compiles (smoke timing)")
    first, last = pipe.sweep_metrics
    for i, auc in enumerate(pipe.sweep_metrics, 1):
        log(tag, f"sweep {i} validation AUC {auc}")
    # the coordinate ladder is a one-sweep property (tests/test_e2e_pipeline);
    # sweep 2 refits every coordinate against the others' newest scores
    smoke.require(tag, "sweep 1: global AUC > 0.55", first["global"] > 0.55)
    smoke.require(tag, "sweep 1: per-user AUC > global + 0.01",
                  first["per-user"] > first["global"] + 0.01)
    smoke.require(tag, "sweep 1: per-movie AUC > per-user",
                  first["per-movie"] > first["per-user"])
    smoke.check(tag, "sweep 2 full-model AUC drop below sweep 1",
                max(first["per-movie"] - last["per-movie"], 0.0),
                PIPELINE_SWEEP_AUC_SLACK)


# ---------------------------------------------------------- four cards ----

def bytes_in_use(tag):
    """Per card: the allocator's bytes in use, and the bytes of the live
    array shards placed there. Returns the latter."""
    import jax
    shards = {d: 0 for d in jax.devices()}
    for arr in jax.live_arrays():
        for sh in arr.addressable_shards:
            shards[sh.device] += sh.data.nbytes
    allocator = {d: (d.memory_stats() or {}).get("bytes_in_use", 0)
                 for d in jax.devices()}
    log(tag, "per card (allocator bytes in use / live shard bytes): "
        + ", ".join(f"{d.id}: {allocator[d] / 2**20:.1f} / "
                    f"{shards[d] / 2**20:.1f} MiB" for d in jax.devices()))
    return list(shards.values())


def _collectives(compiled_text):
    """(op, elements of its largest output array) for every cross-device
    collective in compiled HLO, async -start forms and tuple outputs
    included."""
    out = []
    for line in compiled_text.splitlines():
        m = re.search(r"=(.*?) (all-gather|all-reduce|all-to-all|"
                      r"collective-permute|reduce-scatter)(?:-start)?\(", line)
        if m:
            sizes = [int(np.prod([int(v) for v in dims.split(",") if v]))
                     for dims in re.findall(r"\w+\[([\d,]*)\]", m.group(1))]
            out.append((m.group(2), max(sizes, default=1)))
    return out


def phase_fe_mesh(smoke, tmp):
    """The FE objective and fit on the 4-card data-parallel mesh vs one card:
    the objective at a fixed θ (both against the float64 reference), the
    compiled program's collectives, the per-funcall time, and
    FE_FIT_ITERS[-1]-iteration fits in float32 and in float64."""
    import jax
    import jax.numpy as jnp
    from gdmix_tpu.ops.logistic import SparseBatch
    from gdmix_tpu.parallel.mesh import batch_sharding, get_mesh
    ndev = len(jax.devices())
    batch = fe_batch(FE_D, 0.0, seed=0)
    host = _host(batch)
    x = jnp.asarray(0.05 * np.random.RandomState(3).randn(FE_D + 1),
                    jnp.float32)
    v_ref, g_ref = fe_reference(np.asarray(x, np.float64), *host, l2=FE_L2)
    meshes = {1: get_mesh(jax.devices()[:1]), ndev: get_mesh()}
    steady = {}
    for k, mesh in meshes.items():
        tag = f"{k}-card"
        model, _ = _fe_model(tmp, FE_D, mesh=mesh)
        b = SparseBatch(*[jax.device_put(a, batch_sharding(mesh, rank=a.ndim))
                          for a in batch])
        fun = jax.jit(lambda xx, bb, m=model: m._objective_fun(bb, None)(xx))
        coll = _collectives(fun.lower(x, b).compile().as_text())
        (v, g), first, _ = timed(fun, x, b)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fun(x, b))
            times.append(time.perf_counter() - t0)
        steady[k] = float(np.median(times))
        log("fe-mesh", f"{tag} objective: first call {first:.2f}s, steady "
            f"median {steady[k]:.4f}s per funcall (smoke timing); "
            f"collectives {coll or 'none'}")
        smoke.check("fe-mesh", f"{tag} objective rel err",
                    abs(float(v) - v_ref) / abs(v_ref), FE_OBJ_RTOL)
        smoke.check("fe-mesh", f"{tag} gradient rel L2 err", rel_l2(g, g_ref),
                    FE_GRAD_RTOL)
        if k > 1:
            # each card scans only its own rows: no collective may carry a
            # batch-sized array (the replicated scan gathered all N rows)
            biggest = max([c for _, c in coll] or [0])
            smoke.require("fe-mesh", f"no collective moves a batch-sized "
                          f"array (largest {biggest} elements, N={FE_N})",
                          biggest < FE_N)
    smoke.require("fe-mesh", f"{ndev}-card funcall faster than one card "
                  f"({steady[ndev]:.4f}s vs {steady[1]:.4f}s)",
                  steady[ndev] < steady[1])
    data = _per_record(host)
    iters = FE_FIT_ITERS[-1]
    fits = {k: fe_fit(tmp, data, iters, mesh=mesh)
            for k, mesh in meshes.items()}
    log("fe-mesh", f"float32 {iters}-iteration fit_data: one card "
        f"{fits[1][1]:.2f}s, {ndev}-card mesh {fits[ndev][1]:.2f}s (both "
        "include upload and compile; smoke timing)")
    used = bytes_in_use("fe-mesh")
    smoke.require("fe-mesh", "every card holds a shard of the FE batch",
                  min(used) > FE_N * FE_K * 8 // len(used) // 2)
    # float32 L-BFGS stops once an iteration shows no float32 decrease of
    # the N=5M sum-form loss (ulp ~0.25): each reduction order stops at its
    # own point of that flat region, so the coefficients are reported and
    # the losses compared
    one, four = fits[1][0], fits[ndev][0]
    f1 = fe_reference(one, *host, l2=FE_L2)[0]
    f4 = fe_reference(four, *host, l2=FE_L2)[0]
    log("fe-mesh", f"float32 fits: max |Δcoef| / max |coef| "
        f"{np.max(np.abs(four - one)) / np.max(np.abs(one)):.3e} (reported); "
        f"float64 loss {f1!r} (1 card), {f4!r} ({ndev} cards)")
    smoke.check("fe-mesh", f"float32 fits: float64 loss rel diff, "
                f"{ndev}-card vs 1-card", abs(f4 - f1) / f1, FE_OBJ_RTOL)
    # in float64 both follow one trajectory: the coefficients must agree
    jax.config.update("jax_enable_x64", True)
    try:
        fits = {k: fe_fit(tmp, data, iters, mesh=mesh, dtype="float64")
                for k, mesh in meshes.items()}
    finally:
        jax.config.update("jax_enable_x64", False)
    one, four = fits[1][0], fits[ndev][0]
    log("fe-mesh", f"float64 {iters}-iteration fit_data: one card "
        f"{fits[1][1]:.2f}s, {ndev}-card mesh {fits[ndev][1]:.2f}s (smoke "
        "timing)")
    smoke.check("fe-mesh", f"float64 fits: max |Δcoef| / max |coef|, "
                f"{ndev}-card vs 1-card",
                float(np.max(np.abs(four - one)) / np.max(np.abs(one))),
                FE_MESH_RTOL)


def _dense_models(table, d):
    out = {}
    for eid, sm in table.items():
        theta = np.zeros(1 + d)
        theta[0] = sm.theta[0]
        theta[1 + np.asarray(sm.unique_global_indices, np.int64)] = \
            sm.theta[1:]
        out[eid] = theta
    return out


def phase_re_sharded(smoke, tmp):
    """fit_flat over the sharded plane (route -> group -> solve) on the
    4-card mesh vs fit_flat over the host plane (fit_groups) on one card, on
    the heavy-tail fleet.

    float32, the production setting: reported, with a float64 look at every
    entity the planes fit more than RE_SHARDED_ATOL apart, and the oracle
    sample check. Two float32 solves of one entity stop within the solver's
    own rule (pgtol 1e-5, or no float32-visible decrease) of the optimum,
    up to ~1e-3 away where the curvature is weak; a plane rounding
    differently stops a Newton step earlier or later.
    float64 with pgtol RE_F64_PGTOL: both planes then reach the optimum, so
    they must agree to RE_SHARDED_ATOL on every entity; a record given to the
    wrong entity moves θ by ≥ 8e-4 (float32 CPU calibration: one record
    dropped from each of 300 entities). One-class entities have no finite
    optimum in the intercept; theirs is left out of the bound, and shown."""
    import jax
    from bench import _stage_model
    from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu.parallel.mesh import get_mesh
    fg = re_workload(RE_HEAVY_ENTITIES, seed=1, count_hi=2048, pareto_a=1.2)
    d = int(fg.indices.max()) + 1
    ndev = len(jax.devices())
    two = _two_class(fg)

    def fit(k, plane, f64=False):
        model, base = _stage_model(d, tmp)
        p = model.model_params
        p.re_mode, p.sparsity_threshold = plane, 0.0
        if f64:
            p.dtype, p.lbfgs_pgtol, p.lbfgs_tolerance = \
                "float64", RE_F64_PGTOL, 0.0
        model = RandomEffectLRModel(p, base, mesh=get_mesh(jax.devices()[:k]))
        t0 = time.perf_counter()
        table = _dense_models(model.fit_flat(fg, {}, base), d)
        log("re-sharded", f"{'float64' if f64 else 'float32'} {plane} plane "
            f"on {k} card(s): {time.perf_counter() - t0:.2f}s (includes "
            f"compile; smoke timing), plane {model.last_fit_plane}")
        return np.stack([table[e] for e in fg.entity_ids])

    one, four = fit(1, "host"), fit(ndev, "sharded")
    delta = np.max(np.abs(four - one), axis=1)
    flagged = np.nonzero(delta > RE_SHARDED_ATOL)[0]
    log("re-sharded", f"float32 |Δθ| {ndev}-card vs 1-card per entity: max "
        f"{delta.max():.3e}, median {np.median(delta):.1e}, "
        f"{len(flagged)} of {len(delta)} above {RE_SHARDED_ATOL:.0e}, "
        f"{int((~two[flagged]).sum())} of them one-class")
    eps = float(np.finfo(np.float32).eps)
    look = []
    for e in flagged[two[flagged]]:
        X, y, off = re_entity_problem(fg, e)
        w = np.ones(len(y))
        opt = re_newton_oracle(X, y, w, off, RE_L2)
        f_opt = re_objective(X, y, w, off, RE_L2, opt)[0]
        look.append([len(y)] + [v for t in (one[e], four[e]) for v in (
            np.max(np.abs(t - opt)),
            (re_objective(X, y, w, off, RE_L2, t)[0] - f_opt) / f_opt / eps)])
    if look:
        look = np.array(look)
        log("re-sharded", f"float64 look at the {len(look)} two-class ones "
            f"(n {int(look[:, 0].min())}..{int(look[:, 0].max())}): |θ − θ*| "
            f"max {look[:, 1].max():.3e} (1 card), {look[:, 3].max():.3e} "
            f"({ndev} cards); relative suboptimality max "
            f"{look[:, 2].max():.3f}·ε32 (1 card), {look[:, 4].max():.3f}·ε32 "
            f"({ndev} cards); one side within 1e-5 of θ* for "
            f"{int((np.minimum(look[:, 1], look[:, 3]) <= 1e-5).sum())}")
    re_oracle_check(smoke, "re-sharded", fg,
                    dict(zip(fg.entity_ids, four)))
    jax.config.update("jax_enable_x64", True)
    try:
        one, four = fit(1, "host", True), fit(ndev, "sharded", True)
    finally:
        jax.config.update("jax_enable_x64", False)
    diff = np.abs(four - one)
    log("re-sharded", f"float64 one-class intercepts: max |Δ| "
        f"{diff[~two, 0].max() if (~two).any() else 0.0:.3e} over "
        f"{int((~two).sum())} entities (no finite optimum; reported)")
    diff[~two, 0] = 0.0
    smoke.check("re-sharded", f"float64 max |Δθ|, {ndev}-card sharded vs "
                f"1-card host plane, all {len(fg)} entities",
                float(diff.max()), RE_SHARDED_ATOL)


# ----------------------------------------------------------------- main ----

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="1: every one-card phase; 4: the multi-card path")
    ap.add_argument("--phase", action="append",
                    help="run only this phase of the --chips set (repeatable)")
    args = ap.parse_args(argv)
    restrict_visible_cards(args.chips)

    import jax
    import gdmix_tpu  # noqa: F401  (compile-cache placement)
    from gdmix_tpu import native

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (default backend "
                 f"{jax.default_backend()!r}); nothing was run")
    devices = jax.devices()
    if len(devices) != args.chips:
        sys.exit(f"chip_smoke: need {args.chips} GPUs, JAX sees "
                 f"{len(devices)}")
    for line in card_lines(args.chips):
        print(line, flush=True)
    print(f"jax {jax.__version__}, devices {devices}", flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS') or '(none)'}; "
          f"compile cache {jax.config.jax_compilation_cache_dir}", flush=True)
    loaded = {"tfrecord": native.available(),
              "avro": native._load_avro() is not None,
              "bucketize": native.bucketize_available()}
    print("native codecs: " + ", ".join(
        f"{k} {'loaded' if v else 'python fallback'}"
        for k, v in loaded.items()), flush=True)

    smoke = Smoke()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t_all = time.perf_counter()
    try:
        if args.chips == 1:
            phases = [
                ("precision", lambda: phase_precision(smoke)),
                ("fe-10k", lambda: fe10k_and_fit(smoke, tmp)),
                ("fe-1m", lambda: fe1m(smoke, tmp)),
                ("re-primary", lambda: phase_re(
                    smoke, "re-primary",
                    re_workload(RE_PRIMARY_ENTITIES, seed=0))),
                ("re-heavy", lambda: phase_re(
                    smoke, "re-heavy",
                    re_workload(RE_HEAVY_ENTITIES, seed=1, count_hi=2048,
                                pareto_a=1.2))),
                ("pipeline", lambda: phase_pipeline(smoke, tmp)),
            ]
        else:
            phases = [
                ("fe-mesh", lambda: phase_fe_mesh(smoke, tmp)),
                ("re-sharded", lambda: phase_re_sharded(smoke, tmp)),
                ("pipeline-4", lambda: phase_pipeline(smoke, tmp,
                                                      "pipeline-4")),
            ]
        unknown = set(args.phase or ()) - {name for name, _ in phases}
        if unknown:
            sys.exit(f"chip_smoke: no phase {sorted(unknown)} with "
                     f"--chips {args.chips}")
        for name, run in phases:
            if args.phase and name not in args.phase:
                continue
            t0 = time.perf_counter()
            run()
            jax.clear_caches()
            log(name, f"phase wall {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"total wall {time.perf_counter() - t_all:.1f}s", flush=True)
    if smoke.failed:
        sys.exit("chip_smoke: FAILED: " + "; ".join(smoke.failed))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


def fe10k_and_fit(smoke, tmp):
    _, batch, _, fun, x, g_ref = phase_fe_objective(smoke, tmp, FE_D, 0.0,
                                                    "fe-10k")
    phase_fe_high(batch, FE_D, x, g_ref)
    phase_fe_fit(smoke, tmp, batch, fun)


def fe1m(smoke, tmp):
    _, batch, aux, _, x, _ = phase_fe_objective(smoke, tmp, FE_D_WIDE, 1.2,
                                                "fe-1m")
    phase_fe_cold_side(batch, aux, x)


if __name__ == "__main__":
    main()
