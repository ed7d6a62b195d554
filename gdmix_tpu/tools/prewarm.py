"""Tier-ladder prewarm: compile the sharded RE plane's shape ladder into the
persistent XLA cache BEFORE the first production dispatch.

The sharded plane's first-ever dispatch on a fresh machine compiles the full
tier ladder — route, per-tier pack, and the solver ladder, one jit per (tier
batch, sample cap, support cap, solver config); how long that takes on the GPU
is not measured. All of them land in the persistent compilation cache (on by
default off the CPU, see gdmix_tpu/__init__.py), so running this tool
once — e.g. in an image build or a warm-up job — makes the first production
run compile-free for the covered shapes.

Usage:
  python -m gdmix_tpu.tools.prewarm --tiers 8,16,32,64,128 \
      --entities_per_tier 1024 --support 24 --entry_width 8 \
      [--num_features 10000] [--l2_reg_weight 1.0] [--regularize_bias false]
      [--num_of_lbfgs_iterations 100] [--batch_solver auto]
      [--variance_mode none|simple|full] [--dtype float32] [--host_plane]

The solver config flags MUST match the production run's (they are part of the
compiled computation); shape flags should mirror the production data's tier
ladder — DataPartitioner's max_samples bound caps the ladder in the reference
(DataPartitioner.scala:332-379), and the same bound applies here.

With --host_plane the fit_groups bucket ladder (host marshal plane) prewarms
instead of the sharded plane (the two share solver factories but differ in
batch shapes and the pack/route jits).

Reference: the Spark/TF stack pays per-process TF graph build instead; it has
no persistent-compile analog — this tool exists because XLA compiles are the
cold-start tax of a compiled program.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np

logger = logging.getLogger("gdmix_tpu.prewarm")


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def build_args(argv=None):
    ap = argparse.ArgumentParser(
        "gdmix_tpu.tools.prewarm",
        description="compile the RE solver/tier ladder into the persistent "
                    "XLA cache")
    ap.add_argument("--tiers", default="8,16,32,64,128,256,512,1024",
                    help="comma-separated per-entity sample caps (pow-2)")
    ap.add_argument("--entities_per_tier", default="1024",
                    help="entity count per tier (one value, or one per tier)")
    ap.add_argument("--support", type=int, default=24,
                    help="distinct features per entity (sets the tier u_cap)")
    ap.add_argument("--entry_width", type=int, default=8,
                    help="padded sparse entries per record (K)")
    ap.add_argument("--num_features", type=int, default=10_000)
    ap.add_argument("--l2_reg_weight", type=float, default=1.0)
    ap.add_argument("--regularize_bias", type=_bool, default=False)
    ap.add_argument("--num_of_lbfgs_iterations", type=int, default=100)
    ap.add_argument("--lbfgs_tolerance", type=float, default=1e-12)
    ap.add_argument("--lbfgs_pgtol", type=float, default=1e-5)
    ap.add_argument("--num_of_lbfgs_curvature_pairs", type=int, default=10)
    ap.add_argument("--batch_solver", default="auto")
    ap.add_argument("--newton_phase1_iters", type=int, default=None,
                    help="override REParams default")
    ap.add_argument("--variance_mode", default="none",
                    choices=["none", "simple", "full"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--host_plane", action="store_true",
                    help="prewarm the host bucketize plane (fit_groups) "
                         "instead of the sharded plane")
    return ap.parse_args(argv)


def synthesize(tiers, entities_per_tier, support, k, num_features, seed=0):
    """Per-tier synthetic records: entities_per_tier[i] entities with exactly
    tiers[i] samples each and `support` distinct features — reproduces the
    production plane's (b_cap, n_cap, u_cap) shape triple per tier."""
    from gdmix_tpu.io.input_pipeline import PerRecordData
    rng = np.random.RandomState(seed)
    ents, counts = [], []
    eid = 0
    for cap, e_t in zip(tiers, entities_per_tier):
        for _ in range(e_t):
            ents.append(eid)
            counts.append(cap)
            eid += 1
    counts = np.asarray(counts, np.int64)
    n = int(counts.sum())
    entity_col = np.repeat(np.asarray(ents, np.int64), counts)
    # per-entity support: `support` distinct ids; entries cycle through it
    sup = rng.randint(0, num_features, size=(eid, support))
    rec_ent = entity_col
    indices = sup[rec_ent][:, :k] if support >= k else np.pad(
        sup[rec_ent], ((0, 0), (0, k - support)), mode="wrap")
    indices = np.ascontiguousarray(indices[:, :k]).astype(np.int64)
    values = rng.randn(n, k)
    return PerRecordData(
        columns={"entity": entity_col,
                 "uid": np.arange(n, dtype=np.int64),
                 "response": rng.randint(0, 2, n).astype(np.float64)},
        indices=indices, values=values,
        nnz=np.full(n, min(k, support), np.int64), num_samples=n)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    a = build_args(argv)
    tiers = [int(t) for t in a.tiers.split(",")]
    ept = [int(e) for e in a.entities_per_tier.split(",")]
    if len(ept) == 1:
        ept = ept * len(tiers)
    assert len(ept) == len(tiers), "--entities_per_tier: one value or one " \
                                   "per tier"

    import jax  # noqa: E402  (after gdmix_tpu import chain set platforms)
    from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu.params import Params, REParams, from_dict

    cache = jax.config.jax_compilation_cache_dir
    logger.info("prewarm: devices=%s persistent_cache=%s",
                jax.devices(), cache or "DISABLED (set "
                                        "JAX_COMPILATION_CACHE_DIR)")
    with tempfile.TemporaryDirectory() as root:
        md_file = os.path.join(root, "tensor_metadata.json")
        with open(md_file, "w") as f:
            json.dump({"features": [
                {"name": "bag", "dtype": "float",
                 "shape": [a.num_features], "isSparse": True},
                {"name": "uid", "dtype": "long", "shape": [],
                 "isSparse": False},
                {"name": "entity", "dtype": "long", "shape": [],
                 "isSparse": False}],
                "labels": [{"name": "response", "dtype": "int",
                            "shape": [], "isSparse": False}]}, f)
        over = {}
        if a.newton_phase1_iters is not None:
            over["newton_phase1_iters"] = a.newton_phase1_iters
        mp = from_dict(REParams, dict(
            metadata_file=md_file,
            output_model_dir=os.path.join(root, "m"),
            feature_bag="bag", partition_entity="entity",
            l2_reg_weight=a.l2_reg_weight,
            regularize_bias=a.regularize_bias,
            num_of_lbfgs_iterations=a.num_of_lbfgs_iterations,
            lbfgs_tolerance=a.lbfgs_tolerance,
            lbfgs_pgtol=a.lbfgs_pgtol,
            num_of_lbfgs_curvature_pairs=a.num_of_lbfgs_curvature_pairs,
            batch_solver=a.batch_solver, dtype=a.dtype,
            random_effect_variance_mode=(None if a.variance_mode == "none"
                                         else a.variance_mode),
            **over))
        base = from_dict(Params, dict(
            action="train", stage="random_effect",
            model_type="logistic_regression", label_column_name="response",
            uid_column_name="uid",
            prediction_score_column_name="predictionScore"))
        model = RandomEffectLRModel(mp, base)
        data = synthesize(tiers, ept, a.support, a.entry_width,
                          a.num_features)
        t0 = time.time()
        if a.host_plane:
            from gdmix_tpu.data.partitioner import (PartitionerConfig,
                                                    assign_group_ids,
                                                    group_flat)
            pcfg = PartitionerConfig(partition_entity="entity",
                                     num_partitions=1,
                                     uid_column_name="uid")
            gids = assign_group_ids(data.columns["entity"],
                                    data.columns["uid"], None, None)
            fg = group_flat(data, pcfg, gids, active_only=True)
            out = model.fit_groups(fg, {}, base)
        else:
            # two passes through a device_cache: pass 1 compiles the full
            # route/pack/solve ladder, pass 2 the offsets-only route+pack
            # shapes of the multi-sweep reuse path (both persist)
            dev_cache = {}
            out = model.fit_records_sharded(data, base,
                                            device_cache=dev_cache)
            out = model.fit_records_sharded(data, base,
                                            model_weights=dict(out),
                                            device_cache=dev_cache)
        dt = time.time() - t0
    logger.info("prewarm: %d models over tiers %s in %.1fs — ladder "
                "compiled%s", len(out), tiers, dt,
                f"; persisted to {cache}" if cache else
                " (NOT persisted: no cache dir)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
