"""Random-effect LR: thousands of per-entity models as vmapped on-device solves.

The accelerator re-design of the reference RandomEffectLRLBFGSModel
(/root/reference/gdmix-trainer/src/gdmix/models/custom/random_effect_lr_lbfgs_model.py):

  reference                                     here
  ─────────────────────────────────────────     ───────────────────────────────────
  producer slices per-entity scipy COO          entities bucketed by sample count,
  matrices, Manager().Queue to a                padded to [B, n_cap, K] compact-
  ProcessPoolExecutor                           feature arrays (data/bucketing.py)
  one scipy fmin_l_bfgs_b per entity            ONE vmapped L-BFGS per bucket —
  per process                                   every lane a model, frozen on
                                                convergence (ops/lbfgs.py)
  per-entity variance in numpy                  batched diag/inv in the same jit

Behavior preserved: warm start with prior-model/feature reconciliation, sparsify-
to-support + threshold, photon-ml avro export per partition, validation + active +
passive scoring where entities without a model pass offsets through
(job_consumers.py:144-152), intercept-only models, string or numeric entity ids.
"""
from __future__ import annotations

import functools
import logging
import os
import time
from functools import partial
from typing import Dict, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gdmix_tpu import constants
from gdmix_tpu.data.bucketing import EntityBucket, bucketize
from gdmix_tpu.io import model_avro, scores as scores_io
from gdmix_tpu.io.input_pipeline import load_per_entity_grouped
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.io.model_avro import SparseModel
from gdmix_tpu.io.model_table import (ModelTable, flat_positions,
                                      intersect_prior_support)
from gdmix_tpu.models.api import Model
from gdmix_tpu.ops.lbfgs import lbfgs
from gdmix_tpu.ops.logistic import (SparseBatch, hessian_diag, hessian_full,
                                    per_entity_value_and_grad, predict_logits)
from gdmix_tpu.ops.newton import densify_bucket, newton_lr_batch
from gdmix_tpu.ops.segment import ENTITY_SENTINEL
from gdmix_tpu.parallel.entity_sharding import shard_rows
from gdmix_tpu.parallel.mesh import batch_sharding, get_mesh, pad_to_multiple
from gdmix_tpu.params import Params, REParams, from_argv
from gdmix_tpu.io import fs

logger = logging.getLogger(__name__)

_EPSILON = 1.0e-12


def _variance_one(theta, batch: SparseBatch, u_cap: int, cnt, *, has_intercept,
                  regularize_bias, lam, variance_mode):
    """Per-entity variance (reference binary_logistic_regression.py:144-189).
    Note the reference's Hessian is UN-normalized (no 1/n)."""
    unreg_bias = has_intercept and not regularize_bias
    if variance_mode == constants.SIMPLE:
        hd = hessian_diag(theta, batch, u_cap, has_intercept=has_intercept,
                          intercept_at_end=False) + lam
        if unreg_bias:
            hd = hd.at[0].add(-lam)
        return 1.0 / (hd + _EPSILON)
    H = hessian_full(theta, batch, u_cap, has_intercept=has_intercept,
                     intercept_at_end=False)
    dim = H.shape[0]
    H = H + (lam + _EPSILON) * jnp.eye(dim, dtype=theta.dtype)
    if unreg_bias:
        H = H.at[0, 0].add(-lam)
    return jnp.diagonal(jnp.linalg.inv(H))


def _variance_batch(thetas, a, u_cap, *, has_intercept, regularize_bias, lam,
                    variance_mode):
    def one(theta, idx, val, off, lab, wt, cnt):
        return _variance_one(theta, SparseBatch(idx, val, off, lab, wt), u_cap,
                             cnt, has_intercept=has_intercept,
                             regularize_bias=regularize_bias, lam=lam,
                             variance_mode=variance_mode)
    return jax.vmap(one)(thetas, a["indices"], a["values"], a["offsets"],
                         a["labels"], a["weights"], a["sample_count"])


def _compact_bucket_wire(bucket, b_ship: int, dt=jnp.float32):
    """Host side of the wire-compact bucket upload: narrow every column to
    the smallest lossless dtype and DROP all-zero columns entirely. Wherever
    host→device bandwidth — not the solve — bounds the RE stage rate, wire
    bytes are the lever: local entry indices fit int8
    (u_cap < 128 after per-entity compaction), 0/1 labels and weights ship
    as uint8, cold-start theta0 and first-sweep offsets (all zeros) ship as
    nothing but a flag. Returns (shipped_dict, static_spec) for
    _expand_shipped; every narrowing is exactness-CHECKED on the host, so
    the reconstruction is bit-identical to the eager f32 upload.
    """
    idx = bucket.indices[:b_ship]
    if bucket.u_cap <= 127:
        idx_t = "int8"
    elif bucket.u_cap <= 32767:
        idx_t = "int16"
    else:
        idx_t = "int32"
    shipped = {"indices": jnp.asarray(idx.astype(idx_t, copy=False))}
    spec = {"idx": idx_t, "dim": bucket.theta0.shape[1]}

    # binary-feature datasets (indicator bags — the common recommender
    # case) carry values ∈ {0, 1} (0 = the inert sparse padding), which
    # ship as uint8: 1/4 of the biggest wire column
    val = bucket.values[:b_ship]
    val_u8 = val.astype(np.uint8)
    if np.array_equal(val, val_u8):
        spec["values"] = "u8"
        shipped["values"] = jnp.asarray(val_u8)
    else:
        spec["values"] = "f32"
        shipped["values"] = jnp.asarray(val, dt)

    lab = bucket.labels[:b_ship]
    lab_u8 = lab.astype(np.uint8)
    if np.array_equal(lab, lab_u8):
        spec["labels"] = "u8"
        shipped["labels"] = jnp.asarray(lab_u8)
    else:
        spec["labels"] = "f32"
        shipped["labels"] = jnp.asarray(lab, dt)

    wt = bucket.weights[:b_ship]
    wt_u8 = wt.astype(np.uint8)
    if np.array_equal(wt, wt_u8):
        spec["weights"] = "u8"
        shipped["weights"] = jnp.asarray(wt_u8)
    else:
        spec["weights"] = "f32"
        shipped["weights"] = jnp.asarray(wt, dt)

    off = bucket.offsets[:b_ship]
    if not off.any():
        spec["offsets"] = "zero"
    else:
        spec["offsets"] = "f32"
        shipped["offsets"] = jnp.asarray(off, dt)

    th0 = bucket.theta0[:b_ship]
    if not th0.any():
        spec["theta0"] = "zero"
    else:
        spec["theta0"] = "f32"
        shipped["theta0"] = jnp.asarray(th0, dt)

    shipped["sample_count"] = jnp.asarray(
        bucket.sample_count[:b_ship].astype(np.int32, copy=False))
    return shipped, tuple(sorted(spec.items()))


@functools.lru_cache(maxsize=None)
def _expand_shipped(b_to: int, dt: jnp.dtype, spec: tuple):
    """Cached jit: reconstruct the solver's dtype arrays from the
    wire-compact forms of _compact_bucket_wire and zero-pad the batch axis
    to b_to on device (one compile per (tier batch, spec))."""
    sp = dict(spec)

    @jax.jit
    def expand(shipped):
        bsh, n_cap = shipped["values"].shape[:2]
        a = {"indices": shipped["indices"].astype(jnp.int32),
             "values": shipped["values"].astype(dt),
             "labels": shipped["labels"].astype(dt),
             "sample_count": shipped["sample_count"].astype(dt)}
        a["weights"] = shipped["weights"].astype(dt)
        a["offsets"] = (jnp.zeros((bsh, n_cap), dt)
                        if sp["offsets"] == "zero"
                        else shipped["offsets"].astype(dt))
        a["theta0"] = (jnp.zeros((bsh, sp["dim"]), dt)
                       if sp["theta0"] == "zero"
                       else shipped["theta0"].astype(dt))
        return {k: jnp.pad(v, ((0, b_to - v.shape[0]),)
                           + ((0, 0),) * (v.ndim - 1))
                for k, v in a.items()}
    return expand


@functools.lru_cache(maxsize=None)
def _expand_dyn(b_to: int, dt: jnp.dtype):
    """Cached jit: pad the two SWEEP-DYNAMIC bucket columns (offsets, theta0)
    to the solver batch on device — the upload half of the multi-sweep
    device-array reuse (everything else stays resident in HBM)."""
    @jax.jit
    def expand(off, th0):
        def pad(a):
            return jnp.pad(a.astype(dt), ((0, b_to - a.shape[0]),)
                           + ((0, 0),) * (a.ndim - 1))
        return pad(off), pad(th0)
    return expand


@jax.jit
def _bucket_moved(theta, theta0):
    """One device bool per bucket: did the solve move ANY coefficient off
    its warm start? False ⇒ every entity converged at theta0 and the host
    reconstructs the bucket's models from its own theta0 — no [B, dim]
    downlink fetch (the warm-sweep skip)."""
    return jnp.any(theta != theta0.astype(theta.dtype))


# Module-level cached jitted solvers: one trace per (static config, shape).
@functools.lru_cache(maxsize=None)
def _newton_solver(u_cap, has_intercept, regularize_bias, lam, maxiter, ftol,
                   pgtol, m, variance_mode):
    dim = u_cap + (1 if has_intercept else 0)

    @jax.jit
    def solve(a):
        X = densify_bucket(a["indices"], a["values"], u_cap, has_intercept)
        l2_mask = jnp.ones((dim,), X.dtype)
        if has_intercept and not regularize_bias:
            l2_mask = l2_mask.at[0].set(0.0)
        res = newton_lr_batch(
            a["theta0"], X, a["labels"], a["weights"], a["offsets"],
            a["sample_count"], l2_reg_weight=lam, l2_mask=l2_mask,
            maxiter=maxiter, ftol=ftol, pgtol=pgtol)
        var = _variance_batch(res.theta, a, u_cap, has_intercept=has_intercept,
                              regularize_bias=regularize_bias, lam=lam,
                              variance_mode=variance_mode) \
            if variance_mode else jnp.zeros_like(res.theta)
        return res.theta, var, res.converged
    return solve


@functools.lru_cache(maxsize=None)
def _newton_two_phase_solver(u_cap, has_intercept, regularize_bias, lam,
                             maxiter, ftol, pgtol, m, variance_mode,
                             phase1_iters):
    """Two-phase Newton with DEVICE-SIDE straggler compaction — no host
    round-trip (a host version would fetch every phase-1 theta and ship the
    stragglers back, paying two transfers per bucket).

    Phase 1 runs `phase1_iters` lockstep iterations on the full bucket; the
    lockstep while_loop then makes every lane pay for the slowest, so
    unconverged lanes are compacted to the FRONT on device (stable argsort of
    the converged flags) and finished inside the smallest power-of-two prefix
    that holds them — a lax.switch over a static prefix ladder keeps shapes
    compile-time while the prefix choice stays a runtime scalar. Long-tail
    iterations then cost O(stragglers), not O(bucket)."""
    dim = u_cap + (1 if has_intercept else 0)

    @jax.jit
    def solve(a):
        X = densify_bucket(a["indices"], a["values"], u_cap, has_intercept)
        l2_mask = jnp.ones((dim,), X.dtype)
        if has_intercept and not regularize_bias:
            l2_mask = l2_mask.at[0].set(0.0)
        res1 = newton_lr_batch(
            a["theta0"], X, a["labels"], a["weights"], a["offsets"],
            a["sample_count"], l2_reg_weight=lam, l2_mask=l2_mask,
            maxiter=phase1_iters, ftol=ftol, pgtol=pgtol)
        B = X.shape[0]
        # unconverged lanes first (False sorts before True; argsort is stable)
        order = jnp.argsort(res1.converged)
        n_un = jnp.sum(~res1.converged)
        sizes = []
        s = 64
        while s < B:
            sizes.append(s)
            s *= 2
        sizes.append(B)

        def make_branch(P):
            def branch(_):
                pre = order[:P]
                res2 = newton_lr_batch(
                    res1.theta[pre], X[pre], a["labels"][pre],
                    a["weights"][pre], a["offsets"][pre],
                    a["sample_count"][pre], l2_reg_weight=lam,
                    l2_mask=l2_mask, maxiter=maxiter, ftol=ftol, pgtol=pgtol)
                theta = res1.theta.at[pre].set(res2.theta)
                conv = res1.converged.at[pre].set(res2.converged)
                return theta, conv
            return branch

        # smallest ladder size that holds every straggler
        case = jnp.searchsorted(jnp.asarray(sizes, jnp.int32),
                                n_un.astype(jnp.int32))
        theta, conv = jax.lax.switch(case, [make_branch(P) for P in sizes],
                                     None)
        return theta, jnp.zeros_like(theta), conv
    return solve


@functools.lru_cache(maxsize=None)
def _newton_dual_solver(u_cap, has_intercept, regularize_bias, lam, maxiter,
                        ftol, pgtol, m, variance_mode):
    """Sample-space (Woodbury) Newton: the wide-support fast path. Newton-rate
    convergence at O(n²·dim) per iteration — the n×n kernel Cholesky replaces
    the dim×dim one, so buckets far past newton_max_dim stay dense batched
    work with no [B, dim, dim] Hessian. Selected when samples-per-entity <
    dim (auto)."""
    from gdmix_tpu.ops.newton import dual_variance
    dim = u_cap + (1 if has_intercept else 0)

    @jax.jit
    def solve(a):
        X = densify_bucket(a["indices"], a["values"], u_cap, has_intercept)
        l2_mask = jnp.ones((dim,), X.dtype)
        if has_intercept and not regularize_bias:
            l2_mask = l2_mask.at[0].set(0.0)
        res = newton_lr_batch(
            a["theta0"], X, a["labels"], a["weights"], a["offsets"],
            a["sample_count"], l2_reg_weight=lam, l2_mask=l2_mask,
            maxiter=maxiter, ftol=ftol, pgtol=pgtol, dual=True)
        var = dual_variance(
            res.theta, X, a["labels"], a["weights"], a["offsets"],
            l2_reg_weight=lam, l2_mask=l2_mask,
            full=(variance_mode == constants.FULL), epsilon=_EPSILON) \
            if variance_mode else jnp.zeros_like(res.theta)
        return res.theta, var, res.converged
    return solve


@functools.lru_cache(maxsize=None)
def _lbfgs_dense_solver(u_cap, has_intercept, regularize_bias, lam, maxiter,
                        ftol, pgtol, m, variance_mode):
    """L-BFGS over DENSIFIED per-entity matrices: every funcall is batched
    dense matvec work ([B,n,d] products) instead of per-lane gather/scatter
    chains. The path for wide-support buckets past newton_max_dim. Every
    product pins precision=HIGHEST (see ops/newton.py: reduced-precision
    float32 products would keep pgtol out of reach)."""
    dim = u_cap + (1 if has_intercept else 0)
    unreg_bias = has_intercept and not regularize_bias
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    @jax.jit
    def solve(a):
        X = densify_bucket(a["indices"], a["values"], u_cap, has_intercept)
        mask = jnp.ones((dim,), X.dtype)
        if unreg_bias:
            mask = mask.at[0].set(0.0)

        def one(theta0, Xe, off, lab, wt, cnt):
            inv_n = 1.0 / jnp.maximum(cnt, 1.0)

            def fun(th):
                z = mm(Xe, th) + off
                bce = jnp.maximum(z, 0) - z * lab \
                    + jnp.log1p(jnp.exp(-jnp.abs(z)))
                v = (jnp.sum(wt * bce)
                     + 0.5 * lam * jnp.sum(mask * th * th)) * inv_n
                r = wt * (jax.nn.sigmoid(z) - lab)
                g = (mm(Xe.T, r) + lam * mask * th) * inv_n
                return v, g

            res = lbfgs(fun, theta0, m=m, ftol=ftol, pgtol=pgtol,
                        maxiter=maxiter)
            if variance_mode:
                z = mm(Xe, res.x) + off
                p = jax.nn.sigmoid(z)
                d = wt * p * (1 - p)
                if variance_mode == constants.SIMPLE:
                    hd = mm(d, Xe * Xe) + lam
                    if unreg_bias:
                        hd = hd.at[0].add(-lam)
                    var = 1.0 / (hd + _EPSILON)
                else:
                    H = mm(Xe.T, d[:, None] * Xe) \
                        + (lam + _EPSILON) * jnp.eye(dim, dtype=Xe.dtype)
                    if unreg_bias:
                        H = H.at[0, 0].add(-lam)
                    var = jnp.diagonal(jnp.linalg.inv(H))
            else:
                var = jnp.zeros_like(res.x)
            return res.x, var, res.converged

        return jax.vmap(one)(a["theta0"], X, a["offsets"], a["labels"],
                             a["weights"], a["sample_count"])
    return solve


@functools.lru_cache(maxsize=None)
def _lbfgs_solver(u_cap, has_intercept, regularize_bias, lam, maxiter, ftol,
                  pgtol, m, variance_mode):
    @jax.jit
    def solve(a):
        def one(theta0, idx, val, off, lab, wt, cnt):
            batch = SparseBatch(idx, val, off, lab, wt)
            fun = lambda th: per_entity_value_and_grad(
                th, batch, u_cap, has_intercept=has_intercept,
                regularize_bias=regularize_bias, l2_reg_weight=lam,
                sample_count=cnt)
            res = lbfgs(fun, theta0, m=m, ftol=ftol, pgtol=pgtol,
                        maxiter=maxiter)
            var = _variance_one(res.x, batch, u_cap, cnt,
                                has_intercept=has_intercept,
                                regularize_bias=regularize_bias, lam=lam,
                                variance_mode=variance_mode) \
                if variance_mode else jnp.zeros_like(res.x)
            return res.x, var, res.converged
        return jax.vmap(one)(a["theta0"], a["indices"], a["values"],
                             a["offsets"], a["labels"], a["weights"],
                             a["sample_count"])
    return solve


@functools.lru_cache(maxsize=None)
def _group_scorer(has_intercept):
    @jax.jit
    def score(a):
        def one(theta, idx, val, off, lab, wt):
            batch = SparseBatch(idx, val, off, lab, wt)
            z = predict_logits(theta, batch, has_intercept=has_intercept,
                               intercept_at_end=False)
            return z, z - off
        return jax.vmap(one)(a["theta0"], a["indices"], a["values"],
                             a["offsets"], a["labels"], a["weights"])
    return score


@jax.jit
def _record_scorer(mkey, mvals, icpt, ent_idx, qkey, values, offsets):
    """Sparse per-record scoring: z_pc = θ[e]·x + b[e] against the CSR model
    table (ModelTable.scoring_csr) — O(nnz) memory instead of the dense
    [E+1, D] table's O(E·D) (the reference scores per-entity sparse,
    job_consumers.py:138-152). One vectorized binary-search join: each
    record entry's (entity, feature-rank) key is located in the table's
    sorted combined keys; misses (feature not in the entity's support, or
    entity without a model) contribute 0, so logits = offsets for unmodeled
    entities exactly as before."""
    pos = jnp.minimum(jnp.searchsorted(mkey, qkey), mkey.shape[0] - 1)
    coef = jnp.where(mkey[pos] == qkey, mvals[pos],
                     jnp.zeros((), mvals.dtype))
    z_pc = jnp.sum(coef * values, axis=1) + icpt[ent_idx]
    return z_pc, z_pc + offsets


class RandomEffectLRModel(Model):
    """Batched per-entity logistic regression."""

    # the devices this model's fits run on; None: every local device
    mesh = None

    def __init__(self, model_params: REParams, base_params: Params,
                 mesh=None):
        self.model_params = model_params
        self.base_params = base_params
        self.mesh = mesh
        self.checkpoint_path = model_params.output_model_dir
        self.metadata_file = model_params.metadata_file
        self.feature_bag_name = model_params.feature_bag
        self.has_intercept = model_params.has_intercept
        self.feature_file = (None if self.feature_bag_name is None
                             else model_params.feature_file)
        if model_params.training_data_dir is not None:
            self.training_data_dir = os.path.join(model_params.training_data_dir,
                                                  constants.ACTIVE)
            self.passive_training_data_dir = os.path.join(
                model_params.training_data_dir, constants.PASSIVE)
        else:
            self.training_data_dir = None
            self.passive_training_data_dir = None
        self.validation_data_dir = model_params.validation_data_dir
        self.metadata = DatasetMetadata.from_file(self.metadata_file)
        self.num_features = self.metadata.num_features(self.feature_bag_name)
        self.dtype = jnp.dtype(model_params.dtype)
        # observability for the multi-sweep device caches: how many times
        # static columns actually crossed the link (tests pin this to 1
        # across sweeps; counts BUCKETS on the host plane, PLANES on the
        # sharded one)
        self.static_upload_count = 0
        self.variance_mode = model_params.random_effect_variance_mode

    def _plane_mesh(self):
        """The mesh a fit runs on: the model's own, else every device —
        process-LOCAL under multi-process (the composed two-level
        parallelism: each process solves its owned entities on its own
        devices)."""
        from gdmix_tpu.parallel.mesh import local_mesh
        if self.mesh is not None:
            return self.mesh
        return get_mesh() if jax.process_count() == 1 else local_mesh()

    # ------------------------------------------------------------------ train --

    def train(self, training_data_dir, validation_data_dir, metadata_file,
              checkpoint_path, execution_context, schema_params):
        logger.info("Kicking off random effect LR training (batched on device)")
        partition_index = execution_context[constants.PARTITION_INDEX]
        avro_filename = f"part-{partition_index:05d}.avro"
        model_file = os.path.join(self.model_params.output_model_dir, avro_filename)

        model_weights = self._load_weights(model_file, catch_exception=True)
        from gdmix_tpu.io.input_pipeline import load_per_entity_grouped_flat
        stream = self.model_params.stream_chunk_entities
        streamed = None
        if stream > 0 and self.model_params.data_format == constants.TFRECORD:
            streamed = self._fit_streamed(training_data_dir, model_weights,
                                          schema_params, stream)
        if streamed is not None:
            model_weights = streamed
        else:
            if stream > 0:
                logger.warning(
                    "stream_chunk_entities: streaming needs the native "
                    "tfrecord grouped decoder — loading eagerly instead")
            groups = load_per_entity_grouped_flat(
                training_data_dir, self.metadata,
                self.model_params.partition_entity, self.feature_bag_name,
                data_format=self.model_params.data_format)
            if groups is None:  # non-tfrecord / native-less / ragged presence
                groups = load_per_entity_grouped(
                    training_data_dir, self.metadata,
                    self.model_params.partition_entity, self.feature_bag_name,
                    data_format=self.model_params.data_format)
                model_weights = self.fit_groups(groups, model_weights,
                                                schema_params)
            else:
                model_weights = self.fit_flat(groups, model_weights,
                                              schema_params)
        self._save_model(model_file, model_weights)

        # Scoring
        predict = partial(self._predict_file, schema_params=schema_params,
                          model_weights=model_weights)
        if validation_data_dir:
            o = execution_context.get(constants.VALIDATION_OUTPUT_FILE)
            o and predict(input_path=validation_data_dir, output_file=o)
        if not self.model_params.disable_random_effect_scoring_after_training:
            o = execution_context.get(constants.ACTIVE_TRAINING_OUTPUT_FILE)
            o and predict(input_path=training_data_dir, output_file=o)
            i = execution_context.get(constants.PASSIVE_TRAINING_DATA_DIR)
            o = execution_context.get(constants.PASSIVE_TRAINING_OUTPUT_FILE)
            i and o and predict(input_path=i, output_file=o)

    def _fit_streamed(self, training_data_dir, model_weights, schema_params,
                      chunk_entities: int):
        """Out-of-core RE training: stream the partition as entity-complete
        FlatGroups chunks (io.input_pipeline.iter_per_entity_grouped_flat_chunks)
        and train each chunk through the configured plane (fit_flat), so a
        partition larger than host RAM trains with bounded memory — host RAM
        holds one chunk plus the output model table. The reference bounds the
        same memory with its producer queue (job_consumers.py:161-296,
        max_training_queue_size); here the bound is the chunk size.

        Chunks hold DISJOINT entities except the partitioner's capped-entity
        overflow groups (repeated group ids), which keep the eager path's
        last-wins semantics via deduped_last. Returns the merged mapping, or
        None when the native grouped decoder can't take the dataset (the
        caller then loads eagerly)."""
        from gdmix_tpu.io.input_pipeline import (
            iter_per_entity_grouped_flat_chunks)
        prior = ModelTable.from_models(model_weights, self.has_intercept)
        if len(model_weights) and prior is None:
            return None  # mixed-variance dict prior: eager path handles it
        tables = []
        n_chunks = 0
        for fg in iter_per_entity_grouped_flat_chunks(
                training_data_dir, self.metadata,
                self.model_params.partition_entity, self.feature_bag_name,
                chunk_entities=chunk_entities):
            if fg is None:
                return None
            if len(fg) == 0:
                continue
            n_chunks += 1
            # warm start against the prior rows matching this chunk only:
            # the per-chunk fit then returns a table over exactly the
            # chunk's entities
            if prior is not None and len(prior):
                id2row = prior.id2row
                rows = np.fromiter((id2row.get(e, -1)
                                    for e in fg.entity_ids), np.int64,
                                   len(fg.entity_ids))
                pchunk = prior.select_rows(rows[rows >= 0])
            else:
                pchunk = ModelTable.empty(
                    self.has_intercept,
                    with_variance=self.variance_mode is not None)
            out = self.fit_flat(fg, pchunk, schema_params)
            table = (out if isinstance(out, ModelTable)
                     else ModelTable.from_models(out, self.has_intercept))
            if table is None:  # incompatible prior/new layout: go eager
                return None
            tables.append(table)
        if not tables:
            return (prior if prior is not None and len(prior)
                    else dict(model_weights))
        with_var = tables[0].with_variance
        new = ModelTable.concat(tables, has_intercept=self.has_intercept,
                                with_variance=with_var).deduped_last()
        merged = prior.merged_with(new) if prior is not None and len(prior) \
            else new
        logger.info("streamed RE fit: %d models over %d chunks "
                    "(chunk_entities=%d)", len(merged), n_chunks,
                    chunk_entities)
        return merged

    # ---------------------------------------------------------- bucket solving --

    def _flat_records_view(self, fg):
        """A FlatGroups partition as per-record columns (zero-copy except the
        E-scale entity repeat) — the input form fit_records_sharded takes."""
        from gdmix_tpu.io.input_pipeline import PerRecordData
        cols = dict(fg.columns)
        cols[self.model_params.partition_entity] = np.repeat(
            np.asarray(fg.entity_ids, dtype=object),
            np.asarray(fg.counts, np.int64))
        return PerRecordData(columns=cols, indices=fg.indices,
                             values=fg.values, nnz=fg.rec_nnz,
                             num_samples=int(np.asarray(fg.counts).sum()))

    def fit_flat(self, fg, model_weights: Mapping[str, SparseModel],
                 schema_params,
                 device_cache=None) -> Mapping[str, SparseModel]:
        """Train a columnar FlatGroups partition through the configured
        random-effect plane (REParams.re_mode — the user-facing switch the
        reference lacks, its equivalent plane being the Spark shuffle +
        process pool that is always on, DataPartitioner.scala:235-276):

          sharded — route records to entity-owner shards over the device
                    interconnect and group/pack ON DEVICE
                    (fit_records_sharded); "auto" takes it whenever the
                    feature bag is rectangular AND the mesh has more than one
                    device — on a 1-device mesh there is nothing to route,
                    so auto takes the host marshal there (which of the two
                    is faster on one device is not measured).
          host    — numpy grouping + bucketize (fit_groups).

        Under multi-process, each process solves its own partition on its
        LOCAL mesh; the cross-process level stays partition round-robin +
        model-file exchange (≡ random_effect_driver.py:60-68)."""
        from gdmix_tpu.data.partitioner import factorize_entities
        mesh = self._plane_mesh()
        mode = self.model_params.re_mode
        use_sharded = (mode == "sharded"
                       or (mode == "auto" and fg.indices is not None
                           and len(mesh.devices.flatten()) > 1))
        if not use_sharded:
            return self.fit_groups(fg, model_weights, schema_params,
                                   device_cache=device_cache)
        # FlatGroups is already grouped: factorize the E-scale group ids and
        # expand — skips the N-scale object-column unique (≈0.6 s/100k
        # entities of pure host time in fit_records_sharded otherwise)
        counts = np.asarray(fg.counts, np.int64)
        uniq, ginv = factorize_entities(np.asarray(fg.entity_ids, object))
        inv = np.repeat(ginv, counts)
        ecounts = np.bincount(ginv, weights=counts,
                              minlength=len(uniq)).astype(np.int64)
        return self.fit_records_sharded(self._flat_records_view(fg),
                                        schema_params,
                                        model_weights=model_weights,
                                        mesh=mesh,
                                        entity_groups=(uniq, inv, ecounts),
                                        device_cache=device_cache)

    def fit_groups(self, groups, model_weights: Mapping[str, SparseModel],
                   schema_params,
                   device_cache=None) -> Mapping[str, SparseModel]:
        """In-memory batched training of all entities in `groups` (a
        List[EntityGroup] or columnar FlatGroups); returns the prior ∪ new
        model mapping (prior-only entities carry forward, reference :155-163).
        The result is an immutable columnar ModelTable in the common layouts
        (a plain dict only when the prior mixes variance presence); callers
        needing a mutable dict should wrap it with dict(...)."""
        from gdmix_tpu.data.bucketing import FlatGroups, iter_bucketize_flat
        logger.info("Training %d entities", len(groups))
        tt = [("start", time.time())]  # per-phase wall marks (reference-style)
        # link-traffic accounting for the drift-proof bench decomposition
        #: how many bytes this fit moved host->device
        # (accumulated by _bucket_device_arrays) and device->host
        self.last_fit_bytes_up = 0
        self.last_fit_bytes_down = 0
        self.last_fit_plane = "host"
        bucketize_fn = (iter_bucketize_flat if isinstance(groups, FlatGroups)
                        else bucketize)
        buckets = bucketize_fn(groups, schema_params,
                               self.model_params.offset_column_name,
                               has_intercept=self.has_intercept,
                               prior_models=model_weights)
        # dispatch every bucket's solve before fetching any result, consuming
        # buckets from the marshaling GENERATOR: device_put and the solve
        # dispatch are both ASYNC, so tier t's upload+solve overlap tier
        # t+1's host marshal already; the loop stays single-threaded on
        # purpose (a background upload thread contends for the dispatch
        # lock)
        pending = []
        for i, bucket in enumerate(buckets):
            arrays = self._bucket_device_arrays(bucket, cache=device_cache,
                                                cache_key=i)
            solved = self._select_solver(bucket.u_cap,
                                         bucket.indices.shape[0],
                                         bucket.n_cap)(arrays)
            # keep the device theta0 for the warm-sweep downlink skip below
            pending.append((bucket, solved, arrays["theta0"]))
        tt.append(("marshal_dispatch", time.time()))
        # Warm-sweep downlink skip: a bucket whose solve did not move any
        # coefficient (every entity converged at its warm start — the common
        # case from sweep 2 of coordinate descent on) reconstructs its thetas
        # from the host-resident theta0 instead of fetching [B, dim] floats
        # back over the link. One bool per bucket crosses the wire to decide.
        if self.variance_mode is None and model_weights:
            flags = [_bucket_moved(solved[0], th0)
                     for _, solved, th0 in pending]
            moved = [bool(f) for f in jax.device_get(flags)]
            pending = [
                (bucket,
                 solved if mv else
                 (np.ascontiguousarray(bucket.theta0, dtype=np.float64),)
                 + tuple(solved[1:]))
                for (bucket, solved, _), mv in zip(pending, moved)]
        else:
            pending = [(bucket, solved) for bucket, solved, _ in pending]
        # start every bucket's device→host copy before fetching any: the
        # np.asarray(device_get(...)) calls below then overlap instead of
        # serializing one round trip per array
        fetch_n = 2 if self.variance_mode else 1   # thetas (+ variances)
        # fetch only the REAL rows: the batch axis pow-2 padding stays on
        # device (device→host shares the same link the bucket upload uses)
        pending = [
            (bucket,
             tuple(t[:pad_to_multiple(max(len(bucket.entity_ids), 1), 8)]
                   for t in solved[:fetch_n]) + tuple(solved[fetch_n:]))
            for bucket, solved in pending]
        for _, solved in pending:
            for t in solved[:fetch_n]:
                if hasattr(t, "copy_to_host_async"):
                    t.copy_to_host_async()
                    self.last_fit_bytes_down += int(t.nbytes)
        new = ModelTable.concat(
            [self._collect_bucket_table(bucket, solved)
             for bucket, solved in pending],
            has_intercept=self.has_intercept,
            with_variance=self.variance_mode is not None)
        tt.append(("solve_fetch_collect", time.time()))
        # a capped entity's overflow groups (group_flat_pairs rows with a
        # repeated entity id) each solve a model; keep the last like the
        # pre-columnar dict path did (out[entity_id] = ... last-wins)
        new = new.deduped_last()
        prior = ModelTable.from_models(model_weights, self.has_intercept)
        if prior is None:  # mixed variance presence in the prior dict
            merged = dict(model_weights)
            merged.update(new)
        else:
            merged = prior.merged_with(new)
        tt.append(("merge", time.time()))
        self.last_fit_phases = {nm: tb - ta for (_, ta), (nm, tb)
                                in zip(tt, tt[1:])}
        logger.info("%d models in total after training/refreshing. | %s",
                    len(merged),
                    " ".join(f"{nm}={dt:.3f}s"
                             for nm, dt in self.last_fit_phases.items()))
        return merged

    _STATIC_COLS = ("indices", "values", "labels", "weights", "sample_count")

    def _bucket_device_arrays(self, bucket: EntityBucket, cache=None,
                              cache_key=None):
        """Bucket arrays on device, entity axis sharded over the mesh when it
        divides evenly (row-sharded coefficient table: each chip solves its own
        entities — the in-process multi-chip RE path).

        Single-device meshes ship only the REAL rows, in the wire-compact
        dtypes of _compact_bucket_wire (int8 entry indices, uint8 0/1
        labels/weights, dropped all-zero theta0/offset columns — every
        narrowing exactness-checked on the host), and reconstruct + pow-2
        pad the batch axis on device (a cached expand jit), so the link
        carries the fewest bytes. Solver shapes stay pow-2 (one compile per
        tier/spec).

        `cache`/`cache_key`: multi-sweep device-array reuse. The in-HBM
        pipeline's coordinate-descent sweeps retrain on IDENTICAL records —
        only the offsets (score residuals) and theta0 (warm start) change
        between sweeps — so the five sweep-static columns stay resident in
        HBM and only the two dynamic ones cross the link from sweep 2 on
        (~3× less wire). A hit is accepted only
        when shapes, entity ids and sample counts all match; the CALLER
        owns the stronger invariant that indices/values/labels/weights are
        unchanged for the same key (workflow/pipeline.py does — it mutates
        only the offset column between sweeps)."""
        dt = self.dtype
        # multi-process: the plane mesh is process-LOCAL, so the row
        # sharding and the sweep cache work there too
        mesh = self._plane_mesh()
        ndev = len(mesh.devices.flatten())
        b = bucket.indices.shape[0]
        b_ship = pad_to_multiple(max(len(bucket.entity_ids), 1), 8)
        if cache is not None:
            ent = cache.get(cache_key)
            if (ent is not None and ent["shape"] == bucket.indices.shape
                    and ent["ndev"] == ndev
                    and ent["entity_ids"] == list(bucket.entity_ids)
                    and np.array_equal(ent["sample_count"],
                                       bucket.sample_count)):
                arrays = dict(ent["static"])
                if ent["sharded"]:
                    arrays["offsets"] = jax.device_put(
                        np.asarray(bucket.offsets, dt),
                        batch_sharding(mesh, rank=2))
                    arrays["theta0"] = jax.device_put(
                        np.asarray(bucket.theta0, dt),
                        batch_sharding(mesh, rank=2))
                else:
                    off, th0 = _expand_dyn(b, dt)(
                        jnp.asarray(bucket.offsets[:b_ship], dt),
                        jnp.asarray(bucket.theta0[:b_ship], dt))
                    arrays["offsets"] = off
                    arrays["theta0"] = th0
                # the WIRE is what device_put shipped in dt: the full
                # arrays on the sharded branch, the [:b_ship] slices (the
                # on-device _expand_dyn re-creates the rest) otherwise —
                # host buckets are float64, the wire is self.dtype
                item = np.dtype(dt).itemsize
                if ent["sharded"]:
                    shipped_elems = (np.asarray(bucket.offsets).size
                                     + np.asarray(bucket.theta0).size)
                else:
                    shipped_elems = (
                        np.asarray(bucket.offsets[:b_ship]).size
                        + np.asarray(bucket.theta0[:b_ship]).size)
                self.last_fit_bytes_up = getattr(
                    self, "last_fit_bytes_up", 0) + shipped_elems * item
                return arrays
        if ndev == 1:
            shipped, spec = _compact_bucket_wire(bucket, b_ship, dt)
            self.last_fit_bytes_up = getattr(
                self, "last_fit_bytes_up", 0) + sum(
                int(a.nbytes) for a in jax.tree_util.tree_leaves(shipped)
                if hasattr(a, "nbytes"))
            arrays = _expand_shipped(b, dt, spec)(shipped)
            sharded = False
        else:
            arrays = dict(
                indices=jnp.asarray(bucket.indices),
                values=jnp.asarray(bucket.values, dt),
                offsets=jnp.asarray(bucket.offsets, dt),
                labels=jnp.asarray(bucket.labels, dt),
                weights=jnp.asarray(bucket.weights, dt),
                sample_count=jnp.asarray(bucket.sample_count, dt),
                theta0=jnp.asarray(bucket.theta0, dt),
            )
            # the mesh above is process-local under multi-process, so the
            # row sharding is purely addressable — no global-array rules
            sharded = ndev > 1 and b % ndev == 0
            if sharded:
                arrays = {k: jax.device_put(v,
                                            batch_sharding(mesh, rank=v.ndim))
                          for k, v in arrays.items()}
        if ndev > 1:   # the 1-dev path counted its compact wire above
            self.last_fit_bytes_up = getattr(
                self, "last_fit_bytes_up", 0) + sum(
                int(v.nbytes) for v in arrays.values()
                if hasattr(v, "nbytes"))
        if cache is not None:
            self.static_upload_count += 1
            cache[cache_key] = dict(
                shape=bucket.indices.shape, ndev=ndev, sharded=sharded,
                entity_ids=list(bucket.entity_ids),
                sample_count=np.array(bucket.sample_count, copy=True),
                static={k: arrays[k] for k in self._STATIC_COLS})
        return arrays

    def _solver_key(self, maxiter: int = None):
        p = self.model_params
        return (self.has_intercept, p.regularize_bias, float(p.l2_reg_weight),
                p.num_of_lbfgs_iterations if maxiter is None else maxiter,
                float(p.lbfgs_tolerance),
                float(p.lbfgs_pgtol), p.num_of_lbfgs_curvature_pairs,
                self.variance_mode)

    def _select_solver(self, u_cap: int, B: int, n_cap: int):
        """The solver ladder shared by the host-bucket and sharded planes:
        Newton–Cholesky (dim ≤ newton_max_dim) → sample-space (Woodbury) dual
        Newton (n < dim, kernel fits) → densified L-BFGS → sparse vmapped
        L-BFGS. Solvers are cached at module level so identical (config,
        shape) pairs reuse one jitted computation — fresh closures per bucket
        would defeat jax's jit cache and recompile every bucket)."""
        p = self.model_params
        dim = u_cap + (1 if self.has_intercept else 0)
        use_newton = (p.batch_solver == "newton"
                      or (p.batch_solver == "auto" and dim <= p.newton_max_dim))
        # explicit newton_dual is honored whenever the kernel fits; auto
        # additionally requires n_cap < dim (where sample space is cheaper)
        use_dual = (not use_newton
                    and (p.batch_solver == "newton_dual"
                         or (p.batch_solver == "auto" and n_cap < dim))
                    and B * n_cap * n_cap <= p.dual_newton_max_elems
                    and B * n_cap * dim <= p.dense_lbfgs_max_elems)
        if p.batch_solver == "newton_dual" and not use_dual and not use_newton:
            logger.warning(
                "batch_solver=newton_dual: bucket B=%d n=%d dim=%d exceeds "
                "dual_newton_max_elems/dense_lbfgs_max_elems — falling back "
                "to L-BFGS", B, n_cap, dim)
        use_dense = (not use_newton and not use_dual
                     and B * n_cap * dim <= p.dense_lbfgs_max_elems)
        two_phase = (use_newton and p.newton_phase1_iters > 0
                     and self.variance_mode is None
                     and p.num_of_lbfgs_iterations > p.newton_phase1_iters
                     and B > 64)
        if two_phase:
            return _newton_two_phase_solver(u_cap, *self._solver_key(),
                                            p.newton_phase1_iters)
        return (_newton_solver(u_cap, *self._solver_key()) if use_newton
                else _newton_dual_solver(u_cap, *self._solver_key())
                if use_dual
                else _lbfgs_dense_solver(u_cap, *self._solver_key())
                if use_dense
                else _lbfgs_solver(u_cap, *self._solver_key()))

    def _dispatch_bucket(self, bucket: EntityBucket):
        """Dispatch the bucket's batched solve; returns unsynced device arrays
        (thetas, variances, converged) so callers can pipeline buckets."""
        u_cap = bucket.u_cap
        arrays = self._bucket_device_arrays(bucket)
        B, n_cap = bucket.indices.shape[0], bucket.n_cap
        # device-side straggler compaction (when configured) rides inside
        # _select_solver: ONE dispatch, no host sync — the result stays
        # pipelineable like every other bucket solve
        return self._select_solver(u_cap, B, n_cap)(arrays)

    def _collect_bucket(self, bucket: EntityBucket,
                        solved) -> Dict[str, SparseModel]:
        thetas = np.asarray(jax.device_get(solved[0]), np.float64)
        variances = (np.asarray(jax.device_get(solved[1]), np.float64)
                     if self.variance_mode else None)
        out: Dict[str, SparseModel] = {}
        off = 1 if self.has_intercept else 0
        # vectorized thresholding over the whole bucket (entity slices below
        # are views into the already-thresholded array)
        tau = self.model_params.sparsity_threshold
        thetas = np.where(np.abs(thetas) <= tau, 0.0, thetas)
        for slot, entity_id in enumerate(bucket.entity_ids):
            u = int(bucket.u_count[slot])
            variance = variances[slot][:off + u] if self.variance_mode else None
            out[entity_id] = SparseModel(
                model_id=entity_id, theta=thetas[slot][:off + u],
                variance=variance,
                unique_global_indices=bucket.unique_global_indices[slot, :u].copy())
        return out

    def _collect_bucket_table(self, bucket: EntityBucket,
                              solved) -> ModelTable:
        """_collect_bucket without the per-entity python: one masked gather
        turns the bucket's [B, dim] solution into ModelTable columns."""
        # fetch only what the table needs: variance/converged stay on device
        # when variance is off ([B, dim] of zeros per bucket otherwise rides
        # the link for nothing)
        thetas = np.asarray(jax.device_get(solved[0]), np.float64)
        variances = (np.asarray(jax.device_get(solved[1]), np.float64)
                     if self.variance_mode else None)
        b_real = len(bucket.entity_ids)
        off = 1 if self.has_intercept else 0
        tau = self.model_params.sparsity_threshold
        thetas = np.where(np.abs(thetas) <= tau, 0.0, thetas)
        u_count = bucket.u_count[:b_real].astype(np.int64)
        u_cap = bucket.u_cap
        mask = np.arange(u_cap)[None, :] < u_count[:, None]
        offs = np.zeros(b_real + 1, np.int64)
        np.cumsum(u_count, out=offs[1:])
        with_var = self.variance_mode is not None
        return ModelTable(
            ids=np.asarray(bucket.entity_ids, object), offs=offs,
            coef_ids=bucket.unique_global_indices[:b_real][mask],
            coef_vals=thetas[:b_real, off:off + u_cap][mask],
            icpt=thetas[:b_real, 0].copy() if off else None,
            coef_vars=(variances[:b_real, off:off + u_cap][mask]
                       if with_var else None),
            icpt_vars=(variances[:b_real, 0].copy()
                       if with_var and off else None))

    def _train_bucket(self, bucket: EntityBucket) -> Dict[str, SparseModel]:
        return self._collect_bucket(bucket, self._dispatch_bucket(bucket))

    # ------------------------------------------------- multi-chip sharded fit --

    @staticmethod
    def _entity_supports(inv: np.ndarray, indices, values, nnz,
                         num_entities: int, num_features: int):
        """Per-entity sorted unique feature support from per-record padded-COO
        data, fully vectorized (mirrors bucketize's compact support). Returns
        flat (sup_keys, sup_feat, sup_offs[E+1]) where sup_keys = e*D + feat
        is sorted ascending (the np.unique output, reused for the warm-start
        key intersection)."""
        if indices is None:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(num_entities + 1, np.int64))
        k = indices.shape[1]
        if nnz is not None:
            entry_ok = np.arange(k)[None, :] < nnz[:, None]
        else:
            entry_ok = values != 0
        flat_ent = np.repeat(inv, k)[entry_ok.reshape(-1)]
        flat_feat = indices.reshape(-1)[entry_ok.reshape(-1)].astype(np.int64)
        keys = np.unique(flat_ent.astype(np.int64) * num_features + flat_feat)
        sup_ent = keys // num_features
        sup_feat = keys % num_features
        sup_offs = np.searchsorted(sup_ent, np.arange(num_entities + 1))
        return keys, sup_feat, sup_offs

    def fit_records_sharded(self, data, schema_params,
                            model_weights: Optional[Dict[str, SparseModel]] = None,
                            mesh=None,
                            entity_groups=None,
                            device_cache=None) -> Dict[str, SparseModel]:
        """Multi-chip training straight from per-record data: records are routed
        over the interconnect to the shard owning their entity
        (parallel/entity_sharding ≡ the Spark shuffle-by-entity, DataPartitioner.scala:235-276), grouped
        and packed into per-TIER solver blocks on device, and each chip solves
        its own entities with the shared cached solver ladder (row-sharded
        coefficient table). Output is identical to fit_groups
        (equality-tested).

        Tiering + local indexing: entities are bucketed into power-of-two
        sample-count tiers (the host path's ladder) so one heavy-tailed entity
        doesn't pad every slot to the global max, and every record's feature
        ids are remapped on host to the entity's compact [0, U) support before
        routing — the reference's enable_local_indexing
        (job_consumers.py:209-232) — so each tier's solve dimension is its max
        support, not the global feature count, and theta0 stays
        [slots, u_cap+1] instead of a dense [slots, D+1].

        Slot assignment is fully host-predicted (build_entity_blocks packs
        each shard's entities in ascending entity order), so the whole
        route → pack → solve chain dispatches with NO device round-trip before
        the final result fetch.
        """
        from gdmix_tpu.data.bucketing import _next_pow2, _sample_caps
        from gdmix_tpu.data.partitioner import factorize_entities
        from gdmix_tpu.parallel.entity_sharding import pack_tier, route_records
        tt = [("start", time.time())]  # per-phase wall marks (reference-style)
        # byte accounting covers the host plane only; reset so a previous
        # fit_groups' counters can't leak into this fit's readout (the
        # `plane` field tells the bench which accounting it is looking at)
        self.last_fit_bytes_up = 0
        self.last_fit_bytes_down = 0
        self.last_fit_plane = "sharded"
        model_weights = model_weights if model_weights is not None else {}
        mesh = mesh if mesh is not None else (
            self.mesh if self.mesh is not None else get_mesh())
        num_shards = len(mesh.devices.flatten())
        p = self.model_params
        n = data.num_samples
        dt = self.dtype
        D = self.num_features
        off = 1 if self.has_intercept else 0

        if entity_groups is not None:
            # pre-grouped input (fit_flat): E-scale identity, no N-scale unique
            uniq, inv, counts = entity_groups
            E = len(uniq)
        else:
            uniq, inv = factorize_entities(data.columns[p.partition_entity])
            E = len(uniq)
            counts = np.bincount(inv, minlength=E)
        prior_table = ModelTable.from_models(model_weights, self.has_intercept)
        if E == 0:
            return (prior_table if prior_table is not None
                    else dict(model_weights))

        # multi-sweep device-array reuse (same contract as fit_groups'
        # device_cache): coordinate-descent sweeps retrain on IDENTICAL
        # records — only offsets + warm starts change — so sweep 2+ skips
        # support extraction and re-routes ONLY the offset column;
        # the routed static columns and per-tier packed blocks stay in HBM.
        # A hit requires matching (n, E, shards, counts, entity ids); the
        # CALLER owns the stronger invariant that everything but offsets is
        # unchanged for the same cache dict (workflow/pipeline.py does).
        k_now = data.indices.shape[1] if data.indices is not None else 0
        chit = None
        if device_cache is not None:
            ent_c = device_cache.get("sharded")
            if (ent_c is not None and ent_c["n"] == n and ent_c["E"] == E
                    and ent_c["num_shards"] == num_shards
                    and ent_c["k"] == k_now
                    and np.array_equal(ent_c["counts"], counts)
                    and np.array_equal(ent_c["uniq"], uniq)):
                chit = ent_c
        # round-robin ownership over sorted entity ids (≡ hash partitioning:
        # any deterministic balanced assignment works)
        owner_of_entity = (np.arange(E) % num_shards).astype(np.int32)

        offsets = (data.columns[p.offset_column_name].astype(np.float64)
                   if p.offset_column_name in data.columns else np.zeros(n))
        if chit is None:
            labels = (data.columns[schema_params.label_column_name]
                      .astype(np.float64)
                      if schema_params.label_column_name in data.columns
                      else np.zeros(n))
            weights = (data.columns[schema_params.weight_column_name]
                       .astype(np.float64)
                       if schema_params.weight_column_name
                       and schema_params.weight_column_name in data.columns
                       else np.ones(n))
            if data.indices is not None:
                indices, values = data.indices, data.values
            else:
                indices = np.zeros((n, 1), np.int32)
                values = np.zeros((n, 1))

            # per-entity sorted supports + per-entry LOCAL feature ids (the
            # entity-compact remap rides WITH each record through the exchange)
            nat = None
            if entity_groups is not None and data.indices is not None:
                # pre-grouped records are entity-CONTIGUOUS: the multicore C++
                # per-entity dedup replaces the N-scale unique + searchsorted.
                # The runs follow the caller's record order, which need not
                # be ascending entity index (factorize sorts the ids), so
                # each entity's start is read off its run.
                from gdmix_tpu import native as _native
                run_starts = np.flatnonzero(np.diff(inv, prepend=-1) != 0)
                rec_starts = np.zeros(E, np.int64)
                rec_starts[inv[run_starts]] = run_starts
                nat = _native.entry_local(indices, values, data.nnz,
                                          counts, rec_starts,
                                          use_value_mask=data.nnz is None)
            if nat is not None:
                local_indices, sup_feat, u_counts, sup_offs = nat
                sup_keys = (np.repeat(np.arange(E, dtype=np.int64), u_counts) * D
                            + sup_feat)
            else:
                sup_keys, sup_feat, sup_offs = self._entity_supports(
                    inv, data.indices, data.values, data.nnz, E, D)
                u_counts = np.diff(sup_offs)
                local_indices = np.zeros(indices.shape, np.int32)
                if data.indices is not None and sup_keys.size:
                    k = indices.shape[1]
                    if data.nnz is not None:
                        entry_ok = np.arange(k)[None, :] \
                            < np.asarray(data.nnz)[:, None]
                    else:
                        entry_ok = values != 0
                    flat_pos = np.flatnonzero(entry_ok.ravel())
                    flat_rec = flat_pos // k
                    ent_e = inv[flat_rec].astype(np.int64)
                    fid_e = indices.ravel()[flat_pos].astype(np.int64)
                    pos = np.searchsorted(sup_keys, ent_e * D + fid_e)
                    li = local_indices.reshape(-1)
                    li[flat_pos] = (pos - sup_offs[ent_e]).astype(np.int32)
                    local_indices = li.reshape(indices.shape)
            u_eff = np.maximum(u_counts, 1)

            # power-of-two sample-count tiers (the host bucketize ladder;
            # per-entity assignment — cross-tier lane packing measured
            # slower on an earlier accelerator, see plan_lane_buckets)
            caps = np.asarray(_sample_caps(counts, 8))
            tier_of_entity = np.searchsorted(caps, counts,
                                             side="left").astype(np.int32)

            tt.append(("host_prep", time.time()))
            # pad the record axis so it shards evenly; padding rows carry weight 0
            # and the entity sentinel (they can never enter a block)
            n_pad = pad_to_multiple(max(n, 1), num_shards * 8)
            rows_per_shard = n_pad // num_shards
            extra = n_pad - n

            def padr(a, fill=0.0):
                if not extra:
                    return a
                block = np.full((extra,) + a.shape[1:], fill, a.dtype)
                return np.concatenate([a, block], axis=0)

            ent_rows = padr(inv.astype(np.int32), int(ENTITY_SENTINEL))
            owner_pad = padr(owner_of_entity[inv], 0)
            if extra:  # spread padding rows round-robin (they carry the sentinel)
                owner_pad[n:] = np.arange(extra) % num_shards
            tier_rows = padr(tier_of_entity[inv], 0)

            # exact routing capacity: max records any source shard sends anywhere
            src = np.arange(n_pad) // rows_per_shard
            pair = np.bincount(src * num_shards + owner_pad,
                               minlength=num_shards * num_shards)
            capacity = pad_to_multiple(max(int(pair.max()), 1), 8)
            per_shard_rows = num_shards * capacity  # routed records per shard

            # ONE all-to-all for every payload column incl. entity/tier tags
            routed = route_records(
                mesh,
                dict(indices=shard_rows(mesh, padr(local_indices)),
                     values=shard_rows(mesh, padr(values).astype(dt)),
                     offsets=shard_rows(mesh, padr(offsets).astype(dt)),
                     labels=shard_rows(mesh, padr(labels).astype(dt)),
                     weights=shard_rows(mesh, padr(weights).astype(dt)),
                     _ent=shard_rows(mesh, ent_rows),
                     _tier=shard_rows(mesh, tier_rows)),
                shard_rows(mesh, owner_pad), capacity=capacity)
            r_ent = routed.arrays["_ent"]
            r_tier = routed.arrays["_tier"]
            tt.append(("route", time.time()))

            # host-predicted slot assignment per tier: build_entity_blocks packs
            # each shard's tier members in ascending entity order, so slot =
            # owner·b_cap + rank-within-owner — no device fetch needed
            tiers = []
            slot_of_entity = np.full(E, -1, np.int64)  # slot within the OWN tier
            for t in range(len(caps)):
                members = np.flatnonzero(tier_of_entity == t)
                if members.size == 0:
                    continue
                own_m = owner_of_entity[members]
                per_shard = np.bincount(own_m, minlength=num_shards)
                b_cap_t = min(max(8, _next_pow2(int(per_shard.max()))),
                              per_shard_rows)
                u_cap_t = pad_to_multiple(max(int(u_eff[members].max()), 1), 8)
                order = np.argsort(own_m, kind="stable")   # members already ↑
                sorted_members = members[order]
                shard_of = own_m[order]
                shard_starts = np.searchsorted(shard_of, np.arange(num_shards))
                rank = np.arange(members.size) - shard_starts[shard_of]
                slots = shard_of.astype(np.int64) * b_cap_t + rank
                slot_of_entity[sorted_members] = slots
                tiers.append(dict(t=t, n_cap=int(caps[t]), b_cap=b_cap_t,
                                  u_cap=u_cap_t, members=sorted_members,
                                  slots=slots))
        else:
            (sup_keys, sup_feat, sup_offs, u_counts, tier_of_entity,
             slot_of_entity, tiers, owner_pad, capacity, extra) = (
                chit["sup_keys"], chit["sup_feat"], chit["sup_offs"],
                chit["u_counts"], chit["tier_of_entity"],
                chit["slot_of_entity"], chit["tiers"], chit["owner_pad"],
                chit["capacity"], chit["extra"])
            tt.append(("host_prep", time.time()))
            off_pad = (np.concatenate([offsets, np.zeros(extra)])
                       if extra else offsets)
            routed = route_records(
                mesh, dict(offsets=shard_rows(mesh, off_pad.astype(dt))),
                shard_rows(mesh, owner_pad), capacity=capacity)
            r_ent, r_tier = chit["r_ent"], chit["r_tier"]
            tt.append(("route", time.time()))
        tier_static = {} if device_cache is not None and chit is None else None

        # warm start in LOCAL space (reference prior reconciliation,
        # job_consumers.py:260-288): one key intersection for table priors
        warm_icpt = None   # (entity, value)
        warm_coef = None   # (entity, local position, value)
        if len(model_weights) and prior_table is not None \
                and E * D < (1 << 62):
            id2row = prior_table.id2row
            prow = np.fromiter((id2row.get(u, -1) for u in uniq), np.int64, E)
            ents = np.flatnonzero(prow >= 0)
            if ents.size:
                if off and prior_table.icpt is not None:
                    warm_icpt = (ents, prior_table.icpt[prow[ents]])
                p_ent, _, p_val, pos, hit = intersect_prior_support(
                    prior_table, ents, prow[ents], sup_keys, D)
                warm_coef = (p_ent[hit],
                             pos[hit] - sup_offs[p_ent[hit]], p_val[hit])
        elif len(model_weights):  # mixed-variance dict prior: per-entity path
            wi_e, wi_v, w_e, w_l, w_v = [], [], [], [], []
            for e in range(E):
                prior = model_weights.get(uniq[e])
                if prior is None:
                    continue
                if off:
                    wi_e.append(e)
                    wi_v.append(prior.theta[0])
                sup = sup_feat[sup_offs[e]:sup_offs[e + 1]]
                if len(prior.unique_global_indices) and len(sup):
                    p_idx = np.asarray(prior.unique_global_indices)
                    order = np.argsort(p_idx, kind="stable")
                    p_sorted = p_idx[order]
                    p_theta = np.asarray(prior.theta[off:])[order]
                    pos = np.clip(np.searchsorted(p_sorted, sup), 0,
                                  len(p_sorted) - 1)
                    hit = p_sorted[pos] == sup
                    w_e.append(np.full(int(hit.sum()), e, np.int64))
                    w_l.append(np.flatnonzero(hit).astype(np.int64))
                    w_v.append(p_theta[pos[hit]])
            if wi_e:
                warm_icpt = (np.asarray(wi_e, np.int64), np.asarray(wi_v))
            if w_e:
                warm_coef = (np.concatenate(w_e), np.concatenate(w_l),
                             np.concatenate(w_v))

        tt.append(("plan_warm", time.time()))
        # dispatch every tier's pack + solve before fetching anything
        pending = []
        for ti in tiers:
            dim_t = ti["u_cap"] + off
            theta0 = np.zeros((num_shards * ti["b_cap"], dim_t))
            if warm_icpt is not None:
                we, wv = warm_icpt
                sel = tier_of_entity[we] == ti["t"]
                theta0[slot_of_entity[we[sel]], 0] = wv[sel]
            if warm_coef is not None:
                ce, cl, cv = warm_coef
                sel = tier_of_entity[ce] == ti["t"]
                theta0[slot_of_entity[ce[sel]], off + cl[sel]] = cv[sel]
            sample_count = np.zeros(num_shards * ti["b_cap"])
            sample_count[ti["slots"]] = counts[ti["members"]]
            blocks, _, _, pack_dropped = pack_tier(
                mesh, routed, r_ent, r_tier, ti["t"],
                b_cap=ti["b_cap"], n_cap=ti["n_cap"])
            if chit is not None:
                # sweep 2+: only offsets were re-routed; the static packed
                # columns come from HBM-resident cache
                blocks = dict(chit["tier_static"][ti["t"]],
                              offsets=blocks["offsets"])
            elif tier_static is not None:
                tier_static[ti["t"]] = {
                    k: blocks[k]
                    for k in ("indices", "values", "labels", "weights")}
            solver_arrays = dict(
                blocks,
                sample_count=shard_rows(mesh, sample_count.astype(dt)),
                theta0=shard_rows(mesh, theta0.astype(dt)))
            solve = self._select_solver(
                ti["u_cap"], num_shards * ti["b_cap"], ti["n_cap"])
            solved = solve(solver_arrays)
            fetch = (solved[:2] if self.variance_mode else solved[:1]) \
                + (pack_dropped,)
            for a in fetch:
                if hasattr(a, "copy_to_host_async"):
                    a.copy_to_host_async()
            pending.append((ti, solved, pack_dropped))
        if hasattr(routed.overflow, "copy_to_host_async"):
            routed.overflow.copy_to_host_async()
        if tier_static is not None:
            self.static_upload_count += 1
            device_cache["sharded"] = dict(
                n=n, E=E, k=k_now, num_shards=num_shards,
                counts=np.array(counts, copy=True),
                uniq=np.array(uniq, copy=True),
                sup_keys=sup_keys, sup_feat=sup_feat, sup_offs=sup_offs,
                u_counts=u_counts, tier_of_entity=tier_of_entity,
                slot_of_entity=slot_of_entity, tiers=tiers,
                owner_pad=owner_pad, capacity=capacity, extra=extra,
                r_ent=r_ent, r_tier=r_tier, tier_static=tier_static)
        tt.append(("dispatch", time.time()))

        # columnar collection: gather each tier's support coefficients
        # straight into ModelTable columns (no per-entity python)
        with_var = self.variance_mode is not None
        dropped = int(np.sum(np.asarray(jax.device_get(routed.overflow))))
        tables = []
        for ti, solved, pack_dropped in pending:
            thetas = np.asarray(jax.device_get(solved[0]), np.float64)
            variances = (np.asarray(jax.device_get(solved[1]), np.float64)
                         if with_var else None)
            dropped += int(np.sum(np.asarray(jax.device_get(pack_dropped))))
            thetas = np.where(np.abs(thetas) <= p.sparsity_threshold, 0.0,
                              thetas)
            ents_t, slots_t = ti["members"], ti["slots"]
            lens = u_counts[ents_t]
            src = flat_positions(sup_offs[ents_t], lens)
            inner = np.arange(int(lens.sum())) \
                - np.repeat(np.cumsum(lens) - lens, lens)
            rows = np.repeat(slots_t, lens)
            offs_out = np.zeros(len(ents_t) + 1, np.int64)
            np.cumsum(lens, out=offs_out[1:])
            tables.append(ModelTable(
                ids=uniq[ents_t].astype(object), offs=offs_out,
                coef_ids=sup_feat[src],
                coef_vals=thetas[rows, off + inner],
                icpt=thetas[slots_t, 0].copy() if off else None,
                coef_vars=(variances[rows, off + inner] if with_var
                           else None),
                icpt_vars=(variances[slots_t, 0].copy()
                           if with_var and off else None)))
        assert dropped == 0, (
            f"entity routing dropped {dropped} records (capacity={capacity}, "
            f"tiers={[(ti['b_cap'], ti['n_cap']) for ti in tiers]}) — "
            f"capacities are planned exactly, this is a bug")
        new = ModelTable.concat(tables, has_intercept=self.has_intercept,
                                with_variance=with_var)
        merged = (prior_table.merged_with(new) if prior_table is not None
                  else dict(model_weights))
        if prior_table is None:
            merged.update(new)
        tt.append(("fetch_collect", time.time()))
        self.last_fit_phases = {nm: tb - ta for (_, ta), (nm, tb)
                                in zip(tt, tt[1:])}
        self.last_fit_plane = "sharded"
        logger.info("sharded fit: %d entities over %d shards in %d tiers "
                    "(capacity=%d); %d models total | %s", E, num_shards,
                    len(tiers), capacity, len(merged),
                    " ".join(f"{nm}={tb - ta:.3f}s" for (_, ta), (nm, tb)
                             in zip(tt, tt[1:])))
        return merged

    # ---------------------------------------------------------------- scoring --

    def score_groups(self, groups, model_weights: Dict[str, SparseModel],
                     schema_params) -> Dict[str, np.ndarray]:
        """In-memory scoring of grouped data. Returns {uid, total,
        per_coordinate, labels?, weights?} flat arrays.

        Reusing bucketize: theta0 = prior model restricted to the data's support
        reproduces X·θ exactly (absent features contribute nothing), and
        entities without a model get θ=0 → logits = offsets (reference
        job_consumers.py:144-152)."""
        buckets = bucketize(groups, schema_params,
                            self.model_params.offset_column_name,
                            has_intercept=self.has_intercept,
                            prior_models=model_weights)
        uids, totals, per_coords, labels, weights = [], [], [], [], []
        has_label = schema_params.label_column_name is not None and any(
            schema_params.label_column_name in g.columns for g in groups)
        has_weight = schema_params.weight_column_name is not None and any(
            schema_params.weight_column_name in g.columns for g in groups)
        score = _group_scorer(self.has_intercept)
        # dispatch every bucket's scoring before fetching any result (same
        # round-trip pipelining as fit_groups)
        pending = [(bucket, score(self._bucket_device_arrays(bucket)))
                   for bucket in buckets]
        for _, solved in pending:
            for t in solved:
                if hasattr(t, "copy_to_host_async"):
                    t.copy_to_host_async()
        for bucket, solved in pending:
            z, z_pc = (np.asarray(jax.device_get(t), np.float64)
                       for t in solved)
            # one masked row-major gather per bucket (≡ the per-slot loop:
            # slot 0's first n rows, then slot 1's, ...) — no per-entity python
            b_real = len(bucket.entity_ids)
            n = bucket.sample_count[:b_real].astype(np.int64)
            mask = np.arange(bucket.n_cap)[None, :] < n[:, None]
            uids.append(bucket.uids[:b_real][mask])
            totals.append(z[:b_real][mask])
            per_coords.append(z_pc[:b_real][mask])
            labels.append(bucket.labels[:b_real][mask])
            weights.append(bucket.weights[:b_real][mask])
        out = {"uid": np.concatenate(uids), "total": np.concatenate(totals),
               "per_coordinate": np.concatenate(per_coords)}
        if has_label:
            out["labels"] = np.concatenate(labels)
        if has_weight:
            out["weights"] = np.concatenate(weights)
        return out

    def _model_table(self, model_weights: Dict[str, SparseModel]):
        """Sparse CSR scoring table (ModelTable.scoring_csr) + id→row map —
        O(nnz) memory at any (E, D); row E is the implicit zero model
        (entities without a model score as logits = offsets, reference
        job_consumers.py:144-152)."""
        if isinstance(model_weights, ModelTable):
            mkey, mvals, icpt, uniq = model_weights.scoring_csr()
            return mkey, mvals, icpt, uniq, model_weights.id2row
        E = len(model_weights)
        off = 1 if self.has_intercept else 0
        icpt = np.zeros(E + 1)
        id2row: Dict[str, int] = {}
        rows_l, fids_l, vals_l = [], [], []
        for row, (mid, sm) in enumerate(model_weights.items()):
            id2row[mid] = row
            if off:
                icpt[row] = sm.theta[0]
            k = len(sm.unique_global_indices)
            if k:
                rows_l.append(np.full(k, row, np.int64))
                fids_l.append(np.asarray(sm.unique_global_indices, np.int64))
                vals_l.append(np.asarray(sm.theta[off:], np.float64))
        if rows_l:
            rows = np.concatenate(rows_l)
            fids = np.concatenate(fids_l)
            vals = np.concatenate(vals_l)
        else:
            rows = fids = np.zeros(0, np.int64)
            vals = np.zeros(0, np.float64)
        uniq = np.unique(fids)
        key = rows * np.int64(len(uniq) + 1) + np.searchsorted(uniq, fids)
        order = np.argsort(key, kind="stable")
        return key[order], vals[order], icpt, uniq, id2row

    def _score_columns(self, table, ent_idx, n, columns, indices, values,
                       schema_params):
        p = self.model_params
        mkey, mvals, icpt, uniq, _ = table
        offsets = (columns[p.offset_column_name].astype(np.float64)
                   if p.offset_column_name in columns else np.zeros(n))
        if indices is None:
            indices = np.zeros((n, 1), np.int32)
            values = np.zeros((n, 1))
        # rank-compact the record feature ids against the table's support
        # union; misses take rank U — the hole in each entity's key span, so
        # they can never match a model key (coefficient 0)
        U = len(uniq)
        flat = np.asarray(indices, np.int64).ravel()
        rank = np.searchsorted(uniq, flat)
        hit = rank < U
        if U:  # U == 0 (all-intercept-only table): nothing can match
            hit &= uniq[np.minimum(rank, U - 1)] == flat
        qkey = (np.asarray(ent_idx, np.int64)[:, None] * np.int64(U + 1)
                + np.where(hit, rank, U).reshape(np.shape(indices)))
        if not len(mkey):  # no coefficients anywhere: sentinel never matches
            mkey, mvals = np.full(1, -1, np.int64), np.zeros(1)
        # the combined keys usually fit int32 (span = (E+1)·(U+1)): halve the
        # biggest wire column (the host→device upload of the scoring path)
        if len(icpt) * (U + 1) < (1 << 31):
            qkey = qkey.astype(np.int32)
            mkey = np.asarray(mkey, np.int64).astype(np.int32)
        dt = self.dtype
        z_pc, z = _record_scorer(
            jnp.asarray(mkey), jnp.asarray(mvals, dt), jnp.asarray(icpt, dt),
            jnp.asarray(ent_idx), jnp.asarray(qkey),
            jnp.asarray(values, dt), jnp.asarray(offsets, dt))
        out = {"uid": columns[schema_params.uid_column_name].astype(np.int64),
               "total": np.asarray(z, np.float64),
               "per_coordinate": np.asarray(z_pc, np.float64)}
        if schema_params.label_column_name in columns:
            out["labels"] = columns[schema_params.label_column_name] \
                .astype(np.float64)
        if schema_params.weight_column_name and \
                schema_params.weight_column_name in columns:
            out["weights"] = columns[schema_params.weight_column_name] \
                .astype(np.float64)
        return out

    def score_records(self, data, model_weights: Dict[str, SparseModel],
                      schema_params) -> Dict[str, np.ndarray]:
        """Per-record scoring against the sparse CSR model table — one
        vectorized binary-search join over all records, no grouping/bucketing
        (the in-HBM pipeline's fast path), O(nnz) memory at any (E, D).
        Entities without a model hit the implicit zero row → logits =
        offsets, matching reference job_consumers.py:144-152."""
        from gdmix_tpu.data.partitioner import factorize_entities
        p = self.model_params
        uniq_str, inv = factorize_entities(data.columns[p.partition_entity])
        table = self._model_table(model_weights)
        E = len(model_weights)
        id2row = table[4]
        rows = np.fromiter((id2row.get(e, E) for e in uniq_str),
                           dtype=np.int32, count=len(uniq_str))
        ent_idx = rows[inv]
        return self._score_columns(table, ent_idx, data.num_samples,
                                   data.columns, data.indices, data.values,
                                   schema_params)

    def score_flat(self, fg, model_weights: Dict[str, SparseModel],
                   schema_params, _table=None) -> Dict[str, np.ndarray]:
        """score_records for a columnar FlatGroups: one id→row lookup per
        ENTITY (not per record), then the same single gather-matmul.
        `_table`: a prebuilt _model_table, so chunked callers (the streamed
        inference loop) build the CSR join arrays once, not per chunk."""
        table = _table if _table is not None \
            else self._model_table(model_weights)
        E = len(model_weights)
        id2row = table[4]
        rows = np.fromiter((id2row.get(str(e), E) for e in fg.entity_ids),
                           dtype=np.int32, count=len(fg))
        ent_idx = np.repeat(rows, fg.counts)
        n = int(np.asarray(fg.counts).sum())
        return self._score_columns(table, ent_idx, n, fg.columns, fg.indices,
                                   fg.values, schema_params)

    def _predict_file(self, input_path: str, output_file: str, schema_params,
                      model_weights: Dict[str, SparseModel]) -> None:
        logger.info("Start inference for %s.", input_path)
        from gdmix_tpu.io.input_pipeline import load_per_entity_grouped_flat
        stream = self.model_params.stream_chunk_entities
        if stream > 0 and self.model_params.data_format == constants.TFRECORD:
            # out-of-core inference: score entity-complete chunks — host RAM
            # holds one chunk of data plus the O(N) score scalars (the
            # scoring twin of the streamed fit, ≡ the reference's streaming
            # InferenceJobConsumer pool, job_consumers.py:105-152)
            from gdmix_tpu.io.input_pipeline import \
                iter_per_entity_grouped_flat_chunks
            outs = []
            ok = True
            table = None
            for chunk in iter_per_entity_grouped_flat_chunks(
                    input_path, self.metadata,
                    self.model_params.partition_entity,
                    self.feature_bag_name, chunk_entities=stream):
                if chunk is None:  # native decoder can't take this dataset
                    ok = False
                    break
                if len(chunk):
                    if table is None:  # CSR join arrays built once
                        table = self._model_table(model_weights)
                    outs.append(self.score_flat(chunk, model_weights,
                                                schema_params,
                                                _table=table))
            if ok:
                if not outs:
                    logger.info("No entities found in %s, skipping.",
                                input_path)
                    return
                arrays = {k: np.concatenate([o[k] for o in outs])
                          for k in outs[0]}
                scores_io.write_scores(
                    output_file, schema_params, arrays["uid"],
                    arrays["total"],
                    scores_per_coordinate=arrays["per_coordinate"],
                    labels=arrays.get("labels"),
                    weights=arrays.get("weights"))
                logger.info("Inference complete (streamed): %s.", input_path)
                return
        fg = load_per_entity_grouped_flat(
            input_path, self.metadata, self.model_params.partition_entity,
            self.feature_bag_name, data_format=self.model_params.data_format)
        if fg is not None:
            if not len(fg):
                logger.info("No entities found in %s, skipping.", input_path)
                return
            arrays = self.score_flat(fg, model_weights, schema_params)
            scores_io.write_scores(
                output_file, schema_params, arrays["uid"], arrays["total"],
                scores_per_coordinate=arrays["per_coordinate"],
                labels=arrays.get("labels"), weights=arrays.get("weights"))
            logger.info("Inference complete: %s.", input_path)
            return
        groups = load_per_entity_grouped(input_path, self.metadata,
                                         self.model_params.partition_entity,
                                         self.feature_bag_name,
                                         data_format=self.model_params.data_format)
        if not groups:
            logger.info("No entities found in %s, skipping.", input_path)
            return
        arrays = self.score_groups(groups, model_weights, schema_params)
        scores_io.write_scores(
            output_file, schema_params, arrays["uid"], arrays["total"],
            scores_per_coordinate=arrays["per_coordinate"],
            labels=arrays.get("labels"), weights=arrays.get("weights"))
        logger.info("Inference complete: %s.", input_path)

    # --------------------------------------------------------------- save/load --

    def _save_model(self, output_file: str,
                    model_coefficients: Dict[str, SparseModel]) -> None:
        if isinstance(model_coefficients, ModelTable):
            n = model_avro.export_model_table_to_avro(
                model_coefficients, self.feature_file, output_file,
                sparsity_threshold=self.model_params.sparsity_threshold)
            logger.info("Saved %d random-effect models to %s", n, output_file)
            return
        model_ids = list(model_coefficients.keys())
        biases = [] if self.has_intercept else None
        if self.feature_file is None:
            list_of_weight_indices = list_of_weight_values = None
            assert self.num_features == 1
        else:
            list_of_weight_indices = []
            list_of_weight_values = []
        with_variance = self.variance_mode is not None
        for entity_id, sm in model_coefficients.items():
            idx = 0
            if self.has_intercept:
                if with_variance and sm.variance is not None:
                    biases.append((sm.theta[0], sm.variance[0]))
                else:
                    biases.append(sm.theta[0])
                idx = 1
            if list_of_weight_indices is not None:
                if with_variance and sm.variance is not None:
                    list_of_weight_values.append((sm.theta[idx:], sm.variance[idx:]))
                else:
                    list_of_weight_values.append(sm.theta[idx:])
                list_of_weight_indices.append(sm.unique_global_indices)
        fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        model_avro.export_linear_model_to_avro(
            model_ids, list_of_weight_indices, list_of_weight_values, biases,
            self.feature_file, output_file,
            sparsity_threshold=self.model_params.sparsity_threshold)
        logger.info("Saved %d random-effect models to %s", len(model_ids),
                    output_file)

    def _load_weights(self, model_file: str, catch_exception: bool = False
                      ) -> Dict[str, SparseModel]:
        if not fs.exists(model_file):
            if catch_exception:
                return {}
            raise FileNotFoundError(f"Model file {model_file} does not exist")
        return model_avro.load_sparse_models_from_avro(
            model_file, self.feature_file, has_intercept=self.has_intercept,
            as_table=True)

    # ---------------------------------------------------------------- predict --

    def predict(self, output_dir, input_data_path, metadata_file, checkpoint_path,
                execution_context, schema_params):
        partition_index = execution_context[constants.PARTITION_INDEX]
        avro_filename = f"part-{partition_index:05d}.avro"
        model_weights = self._load_weights(
            os.path.join(checkpoint_path, avro_filename))
        self._predict_file(input_data_path,
                           os.path.join(output_dir, avro_filename),
                           schema_params, model_weights)

    @staticmethod
    def from_argv(argv, base_params: Params) -> "RandomEffectLRModel":
        return RandomEffectLRModel(from_argv(REParams, argv), base_params)
