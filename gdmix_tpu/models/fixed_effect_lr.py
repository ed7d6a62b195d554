"""Fixed-effect LR / linear-regression trainer: data-parallel full-batch L-BFGS.

The accelerator re-design of the reference FixedEffectLRModelLBFGS
(/root/reference/gdmix-trainer/src/gdmix/models/custom/fixed_effect_lr_lbfgs_model.py):

  reference                                     here
  ─────────────────────────────────────────     ───────────────────────────────────
  TF1 graph, tf.while_loop over an epoch        whole dataset in HBM as padded-COO
  per scipy funcall                             arrays; lax.scan over chunks
  collective_ops.all_reduce over gRPC ring      batch sharded over the 1-D mesh;
                                                XLA inserts the all-reduces (GSPMD)
  scipy fmin_l_bfgs_b on every worker,          one on-device L-BFGS (ops/lbfgs.py)
  kept in lockstep by determinism               inside a single jit
  feed_dict placeholder for x                   x is a replicated device array

Semantics preserved: loss = Σ weighted BCE (or squared error) + λ·½‖w‖² with bias
exclusion; coefficient layout [w..., b]; warm start from avro; coefficient
thresholding; scoring of train+validation with predictionScore /
predictionScorePerCoordinate; SIMPLE/FULL training variance; photon-ml avro export.
"""
from __future__ import annotations

import functools
import logging
import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gdmix_tpu import constants
from gdmix_tpu.io import model_avro, scores as scores_io
from gdmix_tpu.io.input_pipeline import PerRecordData, load_per_record
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.models.api import Model
from gdmix_tpu.ops.lbfgs import lbfgs
from gdmix_tpu.ops.logistic import (HybridAux, SparseBatch, build_hybrid_aux,
                                    fixed_effect_value_and_grad,
                                    fixed_effect_value_and_grad_block,
                                    fixed_effect_value_and_grad_hybrid,
                                    fixed_effect_value_and_grad_onehot,
                                    hessian_diag, hessian_full, l2_value_and_grad,
                                    pad_rows, predict_logits)
from gdmix_tpu.params import FixedLRParams, Params, from_argv
from gdmix_tpu.parallel.mesh import (batch_sharding, get_mesh, pad_to_multiple,
                                     replicated, sum_over_rows)
from gdmix_tpu.util.model_utils import threshold_coefficients
from gdmix_tpu.io import fs

logger = logging.getLogger(__name__)

_EPSILON = 1.0e-12

# block_precision → the block/hybrid one-hot dots' precision. "float32" must
# be float32-accurate on every backend: Precision.HIGH is not (on an H100 it
# is TF32), so it maps to HIGHEST; "highest" is its alias from older configs.
_PRECISIONS = {"float32": jax.lax.Precision.HIGHEST,
               "highest": jax.lax.Precision.HIGHEST,
               "default": jax.lax.Precision.DEFAULT,
               # exact two-term bf16 split, single-pass dots — the fast
               # block mode with f32-grade gradients (ops/logistic.py)
               "bf16x2": "bf16x2"}


# Module-level cached jitted scorer: one trace per (has_intercept, shape) —
# fresh jit wrappers per call would defeat jax's jit cache and recompile.
@functools.lru_cache(maxsize=None)
def _fe_scorer(has_intercept: bool):
    @jax.jit
    def score(xx, b):
        z_no_off = predict_logits(
            xx, SparseBatch(b.indices, b.values, jnp.zeros_like(b.offsets),
                            b.labels, b.weights),
            has_intercept=has_intercept, intercept_at_end=True)
        return z_no_off, z_no_off + b.offsets
    return score


@functools.lru_cache(maxsize=None)
def _fe_hessian_diag(num_features: int, has_intercept: bool):
    @jax.jit
    def hd(xx, b):
        return hessian_diag(xx, b, num_features, has_intercept=has_intercept,
                            intercept_at_end=True)
    return hd


@functools.lru_cache(maxsize=None)
def _fe_hessian_full(num_features: int, has_intercept: bool):
    @jax.jit
    def hf(xx, b):
        return hessian_full(xx, b, num_features, has_intercept=has_intercept,
                            intercept_at_end=True)
    return hf


def effective_grad_mode(grad_mode: str, num_features: int,
                        block_min_features: int, onehot_max_features: int,
                        block_max_features: int = 700_000) -> str:
    """Resolve grad_mode (validated against params.GRAD_MODES) to the
    CONCRETE strategy _objective_fun runs.

    "auto" takes the two-level one-hot `block` path for
    block_min_features < D <= block_max_features. Block's cost is O(D) while
    the scatter-add path is D-independent, so past block_max_features auto
    takes `hybrid`: the hot/cold split that runs the frequent-feature
    majority through block's compact one-hot path and only the cold tail
    through per-entry gather/scatter (ops/logistic.py HybridAux; the builder
    itself falls back to plain scatter when the data has no hot set —
    uniform ids). The reference's sparse graph is D-independent the same way
    (fixed_effect_lr_lbfgs_model.py:214-392). At/below onehot_max_features
    the single-level `onehot` densification is taken. The sorted-COO
    `segment` mode is explicit-only. The thresholds are not yet measured on
    the GPU."""
    if grad_mode == "auto":
        if block_min_features < num_features <= block_max_features:
            return "block"
        if num_features <= onehot_max_features:
            return "onehot"
        return "hybrid"
    return grad_mode


class FixedEffectLRModel(Model):
    """Distributed full-batch LR/linear-regression with on-device L-BFGS."""

    def __init__(self, model_params: FixedLRParams, base_params: Params, mesh=None):
        self.model_params = model_params
        self.base_params = base_params
        self.model_type = base_params.model_type
        self.metadata_file = model_params.metadata_file
        self.checkpoint_path = model_params.output_model_dir
        self.training_data_dir = model_params.training_data_dir
        self.validation_data_dir = model_params.validation_data_dir
        self.feature_bag_name = model_params.feature_bag
        self.feature_file = model_params.feature_file if self.feature_bag_name else None
        self.offset_column_name = model_params.offset_column_name
        self.has_intercept = model_params.has_intercept
        self.is_regularize_bias = model_params.regularize_bias
        self.l2_reg_weight = model_params.l2_reg_weight
        self.sparsity_threshold = model_params.sparsity_threshold
        self.variance_mode = model_params.fixed_effect_variance_mode
        if self.model_type == constants.LOGISTIC_REGRESSION:
            self.disable_scoring_after_training = \
                model_params.disable_fixed_effect_scoring_after_training
        else:
            # plain linear regression: no post-train scoring (reference :106-110)
            self.disable_scoring_after_training = True
        if self.variance_mode is not None:
            assert self.model_type == constants.LOGISTIC_REGRESSION

        self.metadata = DatasetMetadata.from_file(self.metadata_file)
        self.num_features = self.metadata.num_features(self.feature_bag_name)
        self.dtype = jnp.dtype(model_params.dtype)
        self.mesh = mesh if mesh is not None else get_mesh()
        self.model_coefficients: Optional[np.ndarray] = None
        self.variances: Optional[np.ndarray] = None
        self._solve_fn = None  # lazily-built jitted solver, reused across calls
        # observability for the multi-sweep device cache: how many times the
        # static columns actually crossed the link (tests pin this to 1)
        self.static_upload_count = 0

    # ------------------------------------------------------------------ data --

    @property
    def _dim(self) -> int:
        return self.num_features + 1 if self.has_intercept else self.num_features

    def _host_arrays(self, data: PerRecordData, schema_params):
        """(indices, values, offsets, labels, weights, uid) host arrays for a
        PerRecordData — the column-extraction half of _device_batch, shared
        with the streamed assembler."""
        n = data.num_samples
        md = self.metadata
        uid = data.column(schema_params.uid_column_name).astype(np.int64)
        if md.has_label(schema_params.label_column_name):
            labels = data.column(schema_params.label_column_name).astype(np.float64)
        else:
            labels = np.zeros(n)
        if md.has_feature(schema_params.weight_column_name):
            weights = data.column(schema_params.weight_column_name).astype(np.float64)
        else:
            weights = np.ones(n)
        if self.offset_column_name in data.columns:
            # present either in the dataset schema or injected by the in-memory
            # pipeline's score ledger
            offsets = data.column(self.offset_column_name).astype(np.float64)
        else:
            offsets = np.zeros(n)
        if self.feature_bag_name:
            indices, values = data.indices, data.values
        else:
            # intercept-only: one dummy zero-valued feature (reference :171-185)
            indices = np.zeros((n, 8), dtype=np.int32)
            values = np.zeros((n, 8), dtype=np.float64)
        return indices, values, offsets, labels, weights, uid

    def _device_batch(self, data: PerRecordData, schema_params,
                      for_training: bool,
                      cache=None) -> Tuple[SparseBatch, np.ndarray, int]:
        """Assemble a padded, device-sharded SparseBatch + uids from host
        columns.

        `cache`: multi-sweep device-array reuse. The in-HBM pipeline's
        sweeps retrain/rescore on IDENTICAL records — only the offset
        column (score residuals) changes — so from sweep 2 on the four
        static columns stay HBM-resident and only offsets cross the link
        (640 MB → ~20 MB per sweep at N=5M). Multi-host composes: each
        process caches its local shard's contribution to the global static
        arrays and re-ships only its local offsets (every process must
        hit/miss CONSISTENTLY — guaranteed by the pipeline's identical sweep
        structure — or the miss path's allgather
        would desynchronize). A hit requires matching shapes AND
        bitwise-equal local uids; the caller owns the stronger invariant
        that indices/values/labels/weights are unchanged
        (workflow/pipeline.py mutates only the offset column)."""
        n = data.num_samples
        indices, values, offsets, labels, weights, uid = \
            self._host_arrays(data, schema_params)
        if cache is not None:
            ent = cache.get("batch")
            if (ent is not None and ent["n"] == n
                    and ent["shape"] == indices.shape
                    and np.array_equal(ent["uid"], uid)):
                n_pad_ = ent["n_pad"]
                off = np.asarray(offsets, self.dtype)
                if len(off) != n_pad_:
                    off = np.concatenate(
                        [off, np.zeros(n_pad_ - n, self.dtype)])
                if jax.process_count() > 1:
                    off_dev = jax.make_array_from_process_local_data(
                        batch_sharding(self.mesh), off)
                else:
                    off_dev = jax.device_put(off, batch_sharding(self.mesh))
                batch = SparseBatch(
                    indices=ent["indices"], values=ent["values"],
                    offsets=off_dev,
                    labels=ent["labels"], weights=ent["weights"])
                return batch, uid, n

        ndev = len(self.mesh.devices.flatten())
        if jax.process_count() > 1:
            # Uneven file shards leave processes with different local row
            # counts; every process must pad to ONE agreed local shape or
            # make_array_from_process_local_data infers inconsistent global
            # shapes. Agree on the max via a host allgather.
            from jax.experimental import multihost_utils
            all_n = multihost_utils.process_allgather(np.asarray(n, np.int64))
            n_common = int(np.max(all_n))
        else:
            n_common = n
        n_pad = pad_to_multiple(max(n_common, 1), ndev * 8)

        def pad(a, fill=0.0):
            if len(a) == n_pad:
                return a
            pad_block = np.full((n_pad - n,) + a.shape[1:], fill, dtype=a.dtype)
            return np.concatenate([a, pad_block], axis=0)

        dt = self.dtype
        bsh = batch_sharding(self.mesh)
        bsh2 = batch_sharding(self.mesh, rank=2)
        if jax.process_count() > 1:
            # Multi-host: every process holds its own shard of the data (file
            # sharding upstream); assemble the global array from local pieces —
            # the pjit-era replacement for per-worker tf.data graphs.
            def put(a, sh):
                return jax.make_array_from_process_local_data(sh, a)
        else:
            def put(a, sh):
                return jax.device_put(a, sh)
        batch = SparseBatch(
            indices=put(pad(indices), bsh2),
            values=put(pad(values).astype(dt), bsh2),
            offsets=put(pad(offsets).astype(dt), bsh),
            labels=put(pad(labels).astype(dt), bsh),
            weights=put(pad(weights).astype(dt), bsh),  # pads → weight 0
        )
        if cache is not None:
            self.static_upload_count += 1
            cache["batch"] = dict(
                n=n, shape=indices.shape, uid=np.array(uid, copy=True),
                n_pad=n_pad,
                indices=batch.indices, values=batch.values,
                labels=batch.labels, weights=batch.weights)
        return batch, uid, n

    def _device_batch_streamed(self, chunks, schema_params
                               ) -> Tuple[SparseBatch, np.ndarray, int]:
        """Assemble the device SparseBatch from a bounded-memory chunk stream
        (io.input_pipeline.iter_per_record_chunks): each chunk moves host→HBM
        as soon as it decodes, so host RAM holds ONE chunk at a time while
        the full dataset lives sharded on the mesh — out-of-core FE
        ingestion (≡ the reference's streaming per_record_input_fn,
        input_data_pipeline.py:129-220, which re-reads the shard from disk
        every funcall; here disk streams once and funcalls stay
        HBM-resident).

        Every chunk but the last must arrive row-aligned to the mesh multiple
        (the chunker yields exact-size chunks), so padding rows — weight 0,
        inert — sit only at the stream's end and uid↔row alignment holds for
        scoring.

        Multi-host: each process streams its OWN file shard (different
        lengths, different chunk counts — a stream can't pre-agree shapes the
        way _device_batch's one-shot allgather does). So chunks stage onto
        this process's LOCAL devices as they decode; at stream end one host
        allgather agrees the common padded local row count and max bag width,
        each process zero-fills up to them ON DEVICE, and the global sharded
        batch is assembled from the per-device shards with no host round-trip
        (every process's segment stays contiguous, padding at its local end —
        the same layout contract _device_batch produces). ≡ the reference's
        streaming per_record_input_fn under distribution
        (input_data_pipeline.py:129-220 + distribution_utils.py:11-47)."""
        nproc = jax.process_count()
        mesh_devs = list(self.mesh.devices.flatten())
        if nproc > 1:
            pid = jax.process_index()
            local_devs = [d for d in mesh_devs if d.process_index == pid]
            # process segments must be contiguous, ascending in the mesh
            # order for the shard-wise global assembly below
            first = mesh_devs.index(local_devs[0])
            assert mesh_devs[first:first + len(local_devs)] == local_devs, \
                "mesh device order must group devices by process"
            from jax.sharding import Mesh, NamedSharding, PartitionSpec
            stage_mesh = Mesh(np.array(local_devs), ("data",))
            bsh = NamedSharding(stage_mesh, PartitionSpec("data"))
            bsh2 = NamedSharding(stage_mesh, PartitionSpec("data", None))
        else:
            local_devs = mesh_devs
            bsh = batch_sharding(self.mesh)
            bsh2 = batch_sharding(self.mesh, rank=2)
        ndev_local = len(local_devs)
        mult = ndev_local * 8
        dt = self.dtype
        dev_chunks, uids = [], []
        n = 0
        k_max = 8
        saw_short = False
        for chunk in chunks:
            # padding must sit only at the stream END (uid↔row alignment for
            # scoring), so only the final chunk may be row-unaligned
            assert not saw_short, "short chunk before the last one"
            saw_short = chunk.num_samples % mult != 0
            indices, values, offsets, labels, weights, uid = \
                self._host_arrays(chunk, schema_params)
            rows = pad_to_multiple(max(chunk.num_samples, 1), mult)

            def pad(a):
                if len(a) == rows:
                    return a
                block = np.zeros((rows - len(a),) + a.shape[1:], a.dtype)
                return np.concatenate([a, block], axis=0)

            k_max = max(k_max, indices.shape[1])
            dev_chunks.append(SparseBatch(
                jax.device_put(pad(indices), bsh2),
                jax.device_put(pad(values).astype(dt), bsh2),
                jax.device_put(pad(offsets).astype(dt), bsh),
                jax.device_put(pad(labels).astype(dt), bsh),
                jax.device_put(pad(weights).astype(dt), bsh)))
            uids.append(uid)
            n += chunk.num_samples
        if not dev_chunks:
            if nproc == 1:
                raise ValueError("empty chunk stream")
            # a process with an empty shard still participates: one
            # all-padding (weight-0, inert) staging chunk
            dev_chunks.append(SparseBatch(
                jax.device_put(np.zeros((mult, k_max), np.int32), bsh2),
                jax.device_put(np.zeros((mult, k_max), dt), bsh2),
                jax.device_put(np.zeros((mult,), dt), bsh),
                jax.device_put(np.zeros((mult,), dt), bsh),
                jax.device_put(np.zeros((mult,), dt), bsh)))

        n_local_pad = sum(c.labels.shape[0] for c in dev_chunks)
        if nproc > 1:
            # agree on (padded local rows, bag width) across processes
            from jax.experimental import multihost_utils
            agreed = multihost_utils.process_allgather(
                np.asarray([n_local_pad, k_max], np.int64))
            n_common = int(agreed[:, 0].max())
            k_max = int(agreed[:, 1].max())
            n_common = pad_to_multiple(max(n_common, mult), mult)
        else:
            n_common = n_local_pad

        def cat(parts, sharding, fill_rows, pad_k=False):
            if pad_k:
                parts = [p if p.shape[1] == k_max
                         else jnp.pad(p, ((0, 0), (0, k_max - p.shape[1])))
                         for p in parts]
            if fill_rows:
                shape = (fill_rows,) + parts[0].shape[1:]
                parts = parts + [jnp.zeros(shape, parts[0].dtype)]
            out = parts[0] if len(parts) == 1 else jnp.concatenate(parts,
                                                                   axis=0)
            # staging shards must divide evenly per local device for the
            # global assembly — make the layout explicit
            return jax.device_put(out, sharding)

        fill = n_common - n_local_pad
        local = SparseBatch(
            cat([c.indices for c in dev_chunks], bsh2, fill, pad_k=True),
            cat([c.values for c in dev_chunks], bsh2, fill, pad_k=True),
            cat([c.offsets for c in dev_chunks], bsh, fill),
            cat([c.labels for c in dev_chunks], bsh, fill),
            cat([c.weights for c in dev_chunks], bsh, fill))
        if nproc == 1:
            return local, np.concatenate(uids), n

        def to_global(arr):
            shards = sorted(arr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            gshape = (arr.shape[0] * nproc,) + arr.shape[1:]
            sh = batch_sharding(self.mesh, rank=arr.ndim)
            return jax.make_array_from_single_device_arrays(
                gshape, sh, [s.data for s in shards])

        batch = SparseBatch(*[to_global(a) for a in local])
        uid = (np.concatenate(uids) if uids
               else np.zeros(0, np.int64))
        return batch, uid, n

    # ------------------------------------------------------------- objective --

    def _objective_fun(self, batch: SparseBatch,
                       hybrid_aux: Optional[HybridAux] = None):
        """(value, grad) of the global objective for a (possibly traced) batch.
        Data-sum via scan over chunks; the λ-term is applied once. On a
        multi-device mesh each device reduces its own rows and one psum
        combines the partial sums (the gRPC ring of reference :384-390;
        parallel/mesh.sum_over_rows). Multi-process note: the batch is always
        passed as a jit ARGUMENT (closing over non-addressable global arrays
        is disallowed). `hybrid_aux`: the hot/cold split for the wide-D
        regime (build_hybrid_aux; None — e.g. the builder declined on uniform
        ids — degrades the `hybrid` mode to plain scatter)."""
        chunk = self.model_params.train_chunk_size
        num_features = self.num_features
        kw = dict(has_intercept=self.has_intercept, regularize_bias=True,
                  l2_reg_weight=0.0, model_type=self.model_type)
        mesh = self.mesh
        ndev = mesh.devices.size
        p = self.model_params
        mode = effective_grad_mode(p.grad_mode, num_features,
                                   p.block_min_features,
                                   p.onehot_max_features,
                                   p.block_max_features)
        n = batch.labels.shape[0]
        batch = pad_rows(batch, ndev)
        if mode == "hybrid" and hybrid_aux is not None:
            hybrid_aux = hybrid_aux._replace(
                hot_idx=pad_rows(hybrid_aux.hot_idx, ndev))

        def with_l2(data_term):
            def fun(x):
                v, g = data_term(x)
                lv, lg = l2_value_and_grad(
                    x, self.l2_reg_weight, has_intercept=self.has_intercept,
                    regularize_bias=self.is_regularize_bias,
                    intercept_at_end=True)
                return v + lv, g + lg
            return fun

        def over_rows(term, rows):
            """term(x, local rows) -> (value, grad), summed over devices."""
            return lambda x: sum_over_rows(
                mesh, lambda xx, r: (term(xx, r), ()), x, rows)[0]

        def rows_of(bb):
            return bb.labels.shape[0]

        if mode == "hybrid" and hybrid_aux is not None:
            hy_chunk = chunk or max(256, min(n, p.block_chunk_size))
            return with_l2(lambda x: fixed_effect_value_and_grad_hybrid(
                x, batch, hybrid_aux, num_features, chunk=hy_chunk,
                has_intercept=self.has_intercept, model_type=self.model_type,
                precision=_PRECISIONS[p.block_precision],
                row_map=functools.partial(sum_over_rows, mesh)))
        # mode == "hybrid" with no aux (builder declined — no hot set in the
        # data — or the caller didn't build one) falls through to scatter.

        if mode == "block":
            def block_term(x, bb):
                ch = chunk or max(256, min(rows_of(bb), p.block_chunk_size))
                return fixed_effect_value_and_grad_block(
                    x, pad_rows(bb, ch), num_features, chunk=ch,
                    has_intercept=self.has_intercept,
                    model_type=self.model_type,
                    precision=_PRECISIONS[p.block_precision])
            return with_l2(over_rows(block_term, batch))

        if mode == "segment":
            # Feature-sorted COO + segment_sum: Xᵀr as a sorted segment
            # reduction instead of a random scatter-add or an O(D) one-hot
            # block sweep — the D-independent wide-feature-space strategy
            # (the reference's sparse graph is D-independent the same way,
            # fixed_effect_lr_lbfgs_model.py:214-392). Each device sorts its
            # own entries ONCE per solve trace (the batch is fixed across
            # L-BFGS iterations), amortized over every funcall in the
            # lax.while loop.
            from gdmix_tpu.ops.logistic import SortedCoo

            def sort_local(_, bb):
                n_, k_ = bb.indices.shape
                flat_idx = bb.indices.reshape(-1).astype(jnp.int32)
                order = jnp.argsort(flat_idx, stable=True)
                return (), SortedCoo(
                    idx=flat_idx[order],
                    row=(jnp.arange(n_ * k_, dtype=jnp.int32) // k_)[order],
                    val=bb.values.reshape(-1)[order])
            _, coo = sum_over_rows(mesh, sort_local, (), batch)
            return with_l2(over_rows(
                lambda x, r: fixed_effect_value_and_grad(
                    x, r[0], num_features, sorted_coo=r[1], **kw),
                (batch, coo)))

        if mode == "onehot":
            def onehot_term(x, bb):
                # chunk sized so the dense [chunk, D] block stays ~128 MB
                ch = chunk or max(256, (1 << 25) // max(num_features, 1))
                ch = min(ch, rows_of(bb))
                return fixed_effect_value_and_grad_onehot(
                    x, pad_rows(bb, ch), num_features, chunk=ch,
                    has_intercept=self.has_intercept,
                    model_type=self.model_type)
            return with_l2(over_rows(onehot_term, batch))

        def scatter_term(x, bb):
            if not chunk or chunk >= rows_of(bb):
                return fixed_effect_value_and_grad(x, bb, num_features, **kw)
            bb = pad_rows(bb, chunk)
            chunked = SparseBatch(*[a.reshape((-1, chunk) + a.shape[1:])
                                    for a in bb])

            def body(carry, ch):
                v, g = carry
                cv, cg = fixed_effect_value_and_grad(
                    x, SparseBatch(*ch), num_features, **kw)
                return (v + cv, g + cg), None
            init = (jnp.zeros((), x.dtype), jnp.zeros_like(x))
            return jax.lax.scan(body, init, tuple(chunked))[0]
        return with_l2(over_rows(scatter_term, batch))

    # ------------------------------------------------------------------ train --

    def fit_data(self, train_data: PerRecordData, schema_params,
                 warm_start: Optional[np.ndarray] = None,
                 device_cache=None) -> np.ndarray:
        """In-memory fit: solve on device, threshold, set model_coefficients.
        The device batch is returned for reuse (scoring/variance).
        device_cache: see _device_batch (multi-sweep static-column reuse)."""
        batch, train_uid, n_train = self._device_batch(train_data, schema_params,
                                                       for_training=True,
                                                       cache=device_cache)
        return self._fit_batch(batch, train_uid, n_train, warm_start,
                               device_cache=device_cache)

    def build_hybrid_aux_for(self, batch: SparseBatch, device_cache=None
                             ) -> Optional[HybridAux]:
        """Hot/cold split for the wide-D fit (ops/logistic.py HybridAux).
        None when grad_mode doesn't resolve to `hybrid` or the data declines
        (no hot set — the builder's data-driven fallback). Cached across
        sweeps: the split depends only on indices/values, which the
        multi-sweep pipeline keeps identical (only offsets change)."""
        p = self.model_params
        mode = effective_grad_mode(p.grad_mode, self.num_features,
                                   p.block_min_features,
                                   p.onehot_max_features,
                                   p.block_max_features)
        if mode != "hybrid":
            return None
        if device_cache is not None and "hybrid_aux" in device_cache:
            return device_cache["hybrid_aux"]
        ndev = len(self.mesh.devices.flatten())
        aux = build_hybrid_aux(
            batch.indices, batch.values, self.num_features,
            hot_features=p.hot_features,
            cold_max_frac=p.hybrid_cold_max_frac,
            pad_multiple=ndev * 8,
            shardings=(replicated(self.mesh),
                       batch_sharding(self.mesh, rank=2),
                       batch_sharding(self.mesh)))
        if device_cache is not None:
            device_cache["hybrid_aux"] = aux
        return aux

    def _fit_batch(self, batch: SparseBatch, train_uid: np.ndarray,
                   n_train: int,
                   warm_start: Optional[np.ndarray] = None,
                   device_cache=None) -> np.ndarray:
        if warm_start is not None and len(warm_start) == self._dim:
            x0 = jnp.asarray(warm_start, self.dtype)
        else:
            x0 = jnp.zeros((self._dim,), self.dtype)
        x0 = jax.device_put(x0, replicated(self.mesh))

        p = self.model_params
        aux = self.build_hybrid_aux_for(batch, device_cache)
        if self._solve_fn is None:
            # one jit wrapper per model instance: repeated fits (multi-sweep
            # pipeline) reuse the compiled computation per input shape
            self._solve_fn = jax.jit(lambda x, b, ax: lbfgs(
                self._objective_fun(b, ax), x,
                m=p.num_of_lbfgs_curvature_pairs,
                ftol=p.lbfgs_tolerance, pgtol=p.lbfgs_pgtol,
                maxiter=p.num_of_lbfgs_iterations))
        res = self._solve_fn(x0, batch, aux)
        logger.info("f_min: %s, iters: %s, funcalls: %s, converged: %s",
                    float(res.f), int(res.num_iterations), int(res.num_funcalls),
                    bool(res.converged))
        coeffs = np.asarray(jax.device_get(res.x), dtype=np.float64)
        self.model_coefficients = threshold_coefficients(coeffs,
                                                         self.sparsity_threshold)
        self._train_batch_cache = (batch, train_uid, n_train)
        return self.model_coefficients

    def score_data(self, data: PerRecordData, schema_params,
                   device_cache=None) -> Dict[str, np.ndarray]:
        """In-memory scoring: {uid, total, per_coordinate, labels?, weights?}.
        device_cache: see _device_batch (multi-sweep static-column reuse)."""
        batch, uid, n = self._device_batch(data, schema_params,
                                           for_training=False,
                                           cache=device_cache)
        return self._score_arrays(batch, uid, n, schema_params)

    def train(self, training_data_dir, validation_data_dir, metadata_file,
              checkpoint_path, execution_context, schema_params):
        logger.info("Kicking off fixed effect LR L-BFGS training")
        task_index = execution_context.get(constants.TASK_INDEX, 0)
        num_workers = execution_context.get(constants.NUM_WORKERS, 1)
        is_chief = execution_context.get(constants.IS_CHIEF, True)

        if self.model_params.copy_to_local:
            training_data_dir = self._copy_shard_to_local(
                training_data_dir, num_workers, task_index)
            num_shards_eff, shard_index_eff = 1, 0
        else:
            num_shards_eff, shard_index_eff = num_workers, task_index
        # Warm start from a prior avro model if shapes match (reference :606-623).
        prev = self._load_model(catch_exception=True)
        if prev is not None and len(prev) == self._dim:
            logger.info("Found a previous model, loaded as the initial point")
        stream = self.model_params.stream_chunk_rows
        if stream > 0 \
                and self.model_params.data_format == constants.TFRECORD \
                and not self.model_params.custom_input_fn:
            # out-of-core ingestion: disk → HBM in bounded-host-memory chunks
            # (multi-host composes: each process streams its own file shard,
            # shapes agreed at stream end — _device_batch_streamed)
            from gdmix_tpu.io.input_pipeline import iter_per_record_chunks
            mult = len(self.mesh.devices.flatten()) * 8
            chunks = iter_per_record_chunks(
                training_data_dir, self.metadata, self.feature_bag_name,
                num_shards=num_shards_eff, shard_index=shard_index_eff,
                chunk_rows=pad_to_multiple(stream, mult))
            batch, train_uid, n_train = self._device_batch_streamed(
                chunks, schema_params)
            logger.info("streamed ingestion: %d records assembled on the mesh "
                        "in chunks of %d rows", n_train,
                        pad_to_multiple(stream, mult))
            self._fit_batch(batch, train_uid, n_train, warm_start=prev)
        else:
            if stream > 0:
                logger.warning(
                    "stream_chunk_rows: streaming needs tfrecord input "
                    "without custom_input_fn — loading eagerly instead")
            train_data = load_per_record(
                training_data_dir, self.metadata, self.feature_bag_name,
                num_shards=num_shards_eff, shard_index=shard_index_eff,
                data_format=self.model_params.data_format,
                feature_file=self.feature_file,
                custom_input_fn=self.model_params.custom_input_fn)
            self.fit_data(train_data, schema_params, warm_start=prev)
        batch, train_uid, n_train = self._train_batch_cache

        want_variance = self.variance_mode is not None
        if not self.disable_scoring_after_training or want_variance:
            self._score_and_write(batch, train_uid, n_train, schema_params,
                                  self.base_params.training_score_dir, task_index,
                                  compute_variance=want_variance)
        if validation_data_dir:
            val_data = load_per_record(validation_data_dir, self.metadata,
                                       self.feature_bag_name,
                                       num_shards=num_workers, shard_index=task_index,
                                       data_format=self.model_params.data_format,
                                       feature_file=self.feature_file,
                                       custom_input_fn=self.model_params.custom_input_fn)
            vbatch, val_uid, n_val = self._device_batch(val_data, schema_params,
                                                        for_training=False)
            self._score_and_write(vbatch, val_uid, n_val, schema_params,
                                  self.base_params.validation_score_dir, task_index)

        if is_chief:
            self._save_model()

    def _copy_shard_to_local(self, data_dir: str, num_workers: int,
                             task_index: int) -> str:
        """Copy this worker's file shard to a local cache dir (reference
        copy_to_local, fixed_effect_lr_lbfgs_model.py:519-531)."""
        from gdmix_tpu.io.shard import shard_input_files
        files, sample_level = shard_input_files(data_dir, num_workers, task_index)
        assert not sample_level, ("copy_to_local needs at least one file per "
                                  "worker")
        local_dir = f"local_training_input_dir_{task_index}"
        os.makedirs(local_dir, exist_ok=True)
        for f in files:   # fs.copy = the remote download half of the contract
            fs.copy(f, os.path.join(local_dir, os.path.basename(f)))
        logger.info("Copied %d files to %s", len(files), local_dir)
        return local_dir

    # ------------------------------------------------------------------ score --

    @staticmethod
    def _to_host_local(arr, n: int) -> np.ndarray:
        """Fetch THIS process's rows of a batch-sharded global array (the rows it
        contributed via make_array_from_process_local_data), truncated to the
        true local count n. Single-process: plain fetch."""
        if jax.process_count() == 1:
            return np.asarray(arr, np.float64)[:n]
        shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start
                        if s.index and s.index[0].start is not None else 0)
        return np.concatenate([np.asarray(s.data, np.float64)
                               for s in shards])[:n]

    def _score_arrays(self, batch: SparseBatch, uid: np.ndarray, n: int,
                      schema_params) -> Dict[str, np.ndarray]:
        x = jnp.asarray(self.model_coefficients, self.dtype)
        z_pc, z = _fe_scorer(self.has_intercept)(x, batch)
        per_coordinate = self._to_host_local(z_pc, n)
        total = self._to_host_local(z, n)
        out = {"uid": uid, "total": total, "per_coordinate": per_coordinate}
        if self.metadata.has_label(schema_params.label_column_name):
            out["labels"] = self._to_host_local(batch.labels, n)
        if self.metadata.has_feature(schema_params.weight_column_name):
            out["weights"] = self._to_host_local(batch.weights, n)
        return out

    def _score_and_write(self, batch: SparseBatch, uid: np.ndarray, n: int,
                         schema_params, output_dir: Optional[str], task_index: int,
                         compute_variance: bool = False) -> None:
        arrays = self._score_arrays(batch, uid, n, schema_params)
        if compute_variance:
            self._compute_variance(batch,
                                   jnp.asarray(self.model_coefficients, self.dtype))
        if output_dir:
            out = os.path.join(output_dir, f"part-{task_index:05d}.avro")
            scores_io.write_scores(out, schema_params, arrays["uid"],
                                   arrays["total"],
                                   scores_per_coordinate=arrays["per_coordinate"],
                                   labels=arrays.get("labels"),
                                   weights=arrays.get("weights"))
            logger.info("Wrote %d scores to %s", n, out)

    def _compute_variance(self, batch: SparseBatch, x: jnp.ndarray) -> None:
        """SIMPLE: 1/(diag H + ε); FULL: diag((H + (λ+ε)I)⁻¹) with the intercept's
        λ removed when unregularized (reference :442-463)."""
        lam = self.l2_reg_weight
        if self.variance_mode == constants.SIMPLE:
            H = np.array(jax.device_get(_fe_hessian_diag(
                self.num_features, self.has_intercept)(x, batch)), np.float64)
            H += lam
            if self.has_intercept and not self.is_regularize_bias:
                H[-1] -= lam
            self.variances = 1.0 / (H + _EPSILON)
        elif self.variance_mode == constants.FULL:
            H = np.array(jax.device_get(_fe_hessian_full(
                self.num_features, self.has_intercept)(x, batch)), np.float64)
            H += np.diag([lam + _EPSILON] * H.shape[0])
            if self.has_intercept and not self.is_regularize_bias:
                H[-1][-1] -= lam
            self.variances = np.diagonal(np.linalg.inv(H))

    # --------------------------------------------------------------- save/load --

    def _save_model(self) -> None:
        compute_variance = self.variances is not None
        if self.has_intercept:
            bias = ((self.model_coefficients[-1], self.variances[-1])
                    if compute_variance else self.model_coefficients[-1])
        else:
            bias = None
        expanded_bias = None if bias is None else [bias]
        if self.feature_bag_name is None:
            list_of_weight_indices = list_of_weight_values = None
        else:
            if self.has_intercept:
                weights = self.model_coefficients[:-1]
                variances = self.variances[:-1] if compute_variance else None
            else:
                weights = self.model_coefficients
                variances = self.variances if compute_variance else None
            indices = np.arange(weights.shape[0])
            list_of_weight_values = [weights] if variances is None \
                else [(weights, variances)]
            list_of_weight_indices = [indices]
        output_file = os.path.join(self.checkpoint_path, "part-00000.avro")
        model_class = (constants.LOGISTIC_MODEL_CLASS
                       if self.model_type == constants.LOGISTIC_REGRESSION
                       else constants.LINEAR_MODEL_CLASS)
        model_avro.export_linear_model_to_avro(
            model_ids=["global model"],
            list_of_weight_indices=list_of_weight_indices,
            list_of_weight_values=list_of_weight_values,
            biases=expanded_bias, feature_file=self.feature_file,
            output_file=output_file, model_class=model_class,
            sparsity_threshold=self.sparsity_threshold)
        logger.info("Saved fixed-effect model to %s", output_file)

    def _load_model(self, catch_exception: bool = False) -> Optional[np.ndarray]:
        path = self.checkpoint_path
        if not path or not fs.isdir(path):
            if catch_exception:
                return None
            raise FileNotFoundError(f"checkpoint path {path} doesn't exist")
        files = [os.path.join(path, f) for f in fs.listdir(path)
                 if f.endswith(".avro")]
        if len(files) != 1:
            if catch_exception:
                return None
            raise ValueError(f"expected exactly one model file in {path}, "
                             f"found {len(files)}")
        model = model_avro.load_linear_models_from_avro(files[0], self.feature_file)[0]
        if self.feature_bag_name is None and model is not None:
            (model,) = model_avro.add_dummy_weight((model,))
        return model

    # ---------------------------------------------------------------- predict --

    def predict(self, output_dir, input_data_path, metadata_file, checkpoint_path,
                execution_context, schema_params):
        logger.info("Kicking off fixed effect LR predict")
        task_index = execution_context.get(constants.TASK_INDEX, 0)
        num_workers = execution_context.get(constants.NUM_WORKERS, 1)
        self.model_coefficients = np.asarray(self._load_model(), dtype=np.float64)
        stream = self.model_params.stream_chunk_rows
        if stream > 0 and jax.process_count() == 1 \
                and self.model_params.data_format == constants.TFRECORD \
                and not self.model_params.custom_input_fn:
            # out-of-core inference: score the shard chunk by chunk — host
            # RAM holds one chunk of DATA plus the O(N) score scalars
            # (≡ the reference streaming scoring through tf.data batches,
            # fixed_effect_lr_lbfgs_model.py:752-807)
            from gdmix_tpu.io.input_pipeline import iter_per_record_chunks
            mult = len(self.mesh.devices.flatten()) * 8
            outs = []
            for chunk in iter_per_record_chunks(
                    input_data_path, self.metadata, self.feature_bag_name,
                    num_shards=num_workers, shard_index=task_index,
                    chunk_rows=pad_to_multiple(stream, mult)):
                b, uid, n = self._device_batch(chunk, schema_params,
                                               for_training=False)
                outs.append(self._score_arrays(b, uid, n, schema_params))
            if not outs:
                logger.info("No records in %s, skipping.", input_data_path)
                return
            arrays = {k: np.concatenate([o[k] for o in outs])
                      for k in outs[0]}
            out = os.path.join(output_dir, f"part-{task_index:05d}.avro")
            scores_io.write_scores(
                out, schema_params, arrays["uid"], arrays["total"],
                scores_per_coordinate=arrays["per_coordinate"],
                labels=arrays.get("labels"), weights=arrays.get("weights"))
            logger.info("Wrote %d streamed scores to %s",
                        len(arrays["uid"]), out)
            return
        data = load_per_record(input_data_path, self.metadata, self.feature_bag_name,
                               num_shards=num_workers, shard_index=task_index,
                               data_format=self.model_params.data_format,
                               feature_file=self.feature_file,
                               custom_input_fn=self.model_params.custom_input_fn)
        batch, uid, n = self._device_batch(data, schema_params, for_training=False)
        self._score_and_write(batch, uid, n, schema_params, output_dir, task_index)

    @staticmethod
    def from_argv(argv, base_params: Params, mesh=None) -> "FixedEffectLRModel":
        return FixedEffectLRModel(from_argv(FixedLRParams, argv), base_params, mesh)
