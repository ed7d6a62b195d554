"""REAL two-process full-pipeline run (2 processes x 4 virtual devices = the
8-device cluster): the 3-coordinate in-HBM pipeline under jax.distributed,
AUC ladder asserted against the single-process run — the SPMD equivalent of the
reference's CI e2e (.github/workflows/movieLens-py37.yml:26-41) plus its
5-worker driver simulation (test/drivers/test_driver.py:13-99).

The RE stage runs re_mode=sharded, composing the two parallelism levels the
reference nests (partitions-across-workers x pool-within-worker,
random_effect_lr_lbfgs_model.py:82-217): entity ownership round-robin across
the 2 processes (model-file exchange) x interconnect routing + on-device grouping over
each process's LOCAL 4-device mesh."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gdmix_tpu.data import movielens
from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory

from tests.test_e2e_pipeline import _config


def test_two_process_pipeline_matches_single(tmp_path):
    root = str(tmp_path)
    data = movielens.generate_synthetic(num_users=60, num_movies=70,
                                        num_ratings=3500, seed=17)
    ml = movielens.prepare_gdmix_data(root, data)

    single_out = os.path.join(root, "single")
    single = run_gdmix_in_memory(_config(ml, single_out), num_sweeps=2)

    mp_out = os.path.join(root, "mp")
    os.makedirs(mp_out)
    runner = os.path.join(os.path.dirname(__file__),
                          "multiproc_pipeline_runner.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, runner, str(pid), "2", ml, mp_out, "9941"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=840)[0].decode() for p in procs]
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"proc {pid} failed:\n{outs[pid][-4000:]}"

    ladders = []
    for pid in range(2):
        with open(os.path.join(mp_out, f"metrics_{pid}.json")) as f:
            obj = json.load(f)
        # the two parallelism levels COMPOSED: every RE coordinate in every
        # sweep went through the sharded plane on the process-LOCAL 4-device
        # mesh (2 coordinates x 2 sweeps), not the host-grouping fallback
        assert obj["sharded_calls"] == ["user_id", "movie_id"] * 2, obj
        # multi-sweep device caches are ACTIVE under multi-host: statics
        # crossed the link once per VIEW, not per sweep —
        # FE = 3 views (fit shard, full-train score, valid score); each RE
        # coordinate's sharded plane = 1 → 2 total
        assert obj["static_uploads"] == {"FixedEffectLRModel": 3,
                                         "RandomEffectLRModel": 2}, obj
        ladders.append(obj["metrics"])
    # both processes computed identical ladders (SPMD determinism)
    assert ladders[0] == ladders[1]
    # and they match the single-process run (different device meshes/summation
    # orders → tight-but-not-bitwise)
    assert set(single) == set(ladders[0])
    for name in single:
        assert abs(single[name] - ladders[0][name]) < 2e-3, \
            (name, single[name], ladders[0][name])
    # AUC ladder shape: personalization coordinates improve on global
    assert ladders[0]["per-movie"] > ladders[0]["global"]
    # chief wrote the final artifacts
    for coord in ("global", "per-user", "per-movie"):
        assert os.path.isfile(os.path.join(mp_out, coord, "models",
                                           "part-00000.avro"))
        assert os.path.isfile(os.path.join(mp_out, coord, "metric",
                                           "evalSummary.json"))


def test_two_process_pipeline_over_fakefs_remote_scheme(tmp_path):
    """The multi-host RE model exchange, score writes and final artifacts
    demonstrably work over a non-POSIX-path scheme with two REAL processes
    sharing ONE backing store: output_dir =
    fakefs://bucket/run, both processes mounting the same hidden local
    directory via GDMIX_FAKEFS_ROOT. MemFS is per-process and cannot test
    this — the reference's whole layer contract is a *shared* store
    (/root/reference/README.md:22)."""
    root = str(tmp_path)
    data = movielens.generate_synthetic(num_users=60, num_movies=70,
                                        num_ratings=3500, seed=17)
    ml = movielens.prepare_gdmix_data(root, data)
    store = os.path.join(root, ".store")
    mp_out = os.path.join(root, "mp_local")
    os.makedirs(mp_out)
    runner = os.path.join(os.path.dirname(__file__),
                          "multiproc_pipeline_runner.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["GDMIX_FAKEFS_ROOT"] = store
    procs = [subprocess.Popen(
        [sys.executable, runner, str(pid), "2", ml, mp_out, "9942",
         "sharded", "fakefs://bucket/run"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=840)[0].decode() for p in procs]
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"proc {pid} failed:\n{outs[pid][-4000:]}"

    ladders = []
    for pid in range(2):
        with open(os.path.join(mp_out, f"metrics_{pid}.json")) as f:
            obj = json.load(f)
        assert obj["sharded_calls"] == ["user_id", "movie_id"] * 2, obj
        ladders.append(obj["metrics"])
    assert ladders[0] == ladders[1]
    assert ladders[0]["per-movie"] > ladders[0]["global"]

    # final artifacts landed in the SHARED backing store (chief-written),
    # and the remote exchange's partial files went through the same scheme
    for coord in ("global", "per-user", "per-movie"):
        assert os.path.isfile(os.path.join(
            store, "bucket/run", coord, "models", "part-00000.avro")), coord
        assert os.path.isfile(os.path.join(
            store, "bucket/run", coord, "metric", "evalSummary.json")), coord
    # no half-written temp objects left behind (commit-on-close contract)
    for dirpath, _, files in os.walk(store):
        assert not [f for f in files if f.endswith(".part~")], (dirpath, files)

    # and the artifacts read back through the scheme itself
    from gdmix_tpu.io import fs as fslib
    from gdmix_tpu.io import model_avro
    fslib._registry.pop("fakefs", None)
    os.environ["GDMIX_FAKEFS_ROOT"] = store
    try:
        models = model_avro.load_linear_models_from_avro(
            "fakefs://bucket/run/global/models/part-00000.avro", None)
        assert len(models) == 1 and models[0].size > 0
    finally:
        fslib._registry.pop("fakefs", None)
        os.environ.pop("GDMIX_FAKEFS_ROOT", None)
