"""REAL two-process jax.distributed fixed-effect training (the multi-host path):
two OS processes, file sharding per process, make_array_from_process_local_data,
cross-process all-reduce — result must equal a single-process run."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gdmix_tpu.io.feature_list import write_feature_list
from gdmix_tpu.io.input_pipeline import write_per_record
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.io.model_avro import load_linear_models_from_avro
from gdmix_tpu.io.scores import read_scores

from tests.test_fixed_effect_lr import _scipy_fe_oracle

D = 6


def _write_dataset(root, file_sizes, seed=5):
    """Write len(file_sizes) TFRecord files with the given row counts."""
    from scipy.special import expit
    rng = np.random.RandomState(seed)
    md_json = {"features": [
        {"name": "global", "dtype": "float", "shape": [D], "isSparse": True},
        {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
        {"name": "weight", "dtype": "float", "shape": [], "isSparse": False}],
        "labels": [{"name": "response", "dtype": "int", "shape": [],
                    "isSparse": False}]}
    md_file = os.path.join(root, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump(md_json, f)
    md = DatasetMetadata.from_file(md_file)
    train_dir = os.path.join(root, "trainingData")
    os.makedirs(train_dir, exist_ok=True)
    X_all, y_all, w_all = [], [], []
    uid = 0
    w_true = rng.randn(D)
    for fi, n in enumerate(file_sizes):
        X = rng.randn(n, D) * (rng.rand(n, D) < 0.6)
        y = (rng.rand(n) < expit(X @ w_true)).astype(np.int64)
        weight = np.ones(n, np.float32)
        cols = {"uid": np.arange(uid, uid + n, dtype=np.int64),
                "weight": weight, "response": y}
        ragged_idx = [np.flatnonzero(X[i]).astype(np.int64) for i in range(n)]
        ragged_val = [X[i][X[i] != 0] for i in range(n)]
        write_per_record(os.path.join(train_dir, f"part-{fi}.tfrecord"), md,
                         cols, "global", ragged_idx, ragged_val)
        X_all.append(X)
        y_all.append(y)
        w_all.append(weight)
        uid += n
    write_feature_list([(f"f{i}", "") for i in range(D)],
                       os.path.join(root, "features.csv"))
    return (np.concatenate(X_all), np.concatenate(y_all).astype(np.float64),
            np.concatenate(w_all).astype(np.float64))


def _run_two_procs(root, port, variance_mode="none", stream_rows=0):
    os.makedirs(os.path.join(root, "models_mp"), exist_ok=True)
    os.makedirs(os.path.join(root, "scores_mp"), exist_ok=True)
    runner = os.path.join(os.path.dirname(__file__), "multiproc_runner.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, runner, str(pid), "2", root, variance_mode, str(port),
         str(stream_rows)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"proc {pid} failed:\n{outs[pid]}"
    (coeffs,) = load_linear_models_from_avro(
        os.path.join(root, "models_mp", "part-00000.avro"),
        os.path.join(root, "features.csv"))
    return coeffs


def _check_scores(root, X, coeffs):
    from gdmix_tpu.params import Params
    sp = Params(action="train", stage="fixed_effect",
                label_column_name="response", uid_column_name="uid",
                weight_column_name="weight",
                prediction_score_column_name="predictionScore")
    got = read_scores(os.path.join(root, "scores_mp"), sp)
    n = len(X)
    assert len(got["uid"]) == n
    np.testing.assert_array_equal(np.sort(got["uid"]), np.arange(n))
    wq, b = coeffs[:-1], coeffs[-1]
    order = np.argsort(got["uid"])
    np.testing.assert_allclose(got["predictionScorePerCoordinate"][order],
                               X @ wq + b, atol=1e-6)


def test_two_process_training_matches_oracle(tmp_path):
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [64, 64])
    coeffs = _run_two_procs(root, port=9923)
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=1e-6)
    _check_scores(root, X, coeffs)


def test_two_process_uneven_shards(tmp_path):
    """Processes hold different local row counts (64 vs 40): they must agree
    on one padded local shape (round-1 bug: per-process n_pad broke
    make_array_from_process_local_data)."""
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [64, 40], seed=6)
    coeffs = _run_two_procs(root, port=9925)
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=1e-6)
    _check_scores(root, X, coeffs)


def test_two_process_single_file_sample_sharding(tmp_path):
    """One input file, two workers: sample-level sharding must split records
    (round-1 bug: both processes trained on every sample → doubled loss)."""
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [96], seed=7)
    coeffs = _run_two_procs(root, port=9927)
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=1e-6)
    _check_scores(root, X, coeffs)


def test_two_process_streamed_ingestion_matches_eager(tmp_path):
    """Multi-host OUT-OF-CORE FE: each process streams
    its file shard in 32-row chunks (uneven shards → different chunk counts
    and a short tail on one process); coefficients must match the scipy
    oracle (hence the eager 2-process run, which matches it too) and the
    score files must stay uid↔row aligned."""
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [64, 40], seed=9)
    coeffs = _run_two_procs(root, port=9931, stream_rows=32)
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=1e-6)
    _check_scores(root, X, coeffs)


def test_two_process_full_variance(tmp_path):
    """FULL variance with the Hessian all-reduced across processes
    (reference fixed_effect_lr_lbfgs_model.py:302-306), validated against a
    finite-difference Hessian of the actual loss — an oracle independent of
    the XᵀDX formula."""
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [48, 48], seed=8)
    coeffs = _run_two_procs(root, port=9929, variance_mode="full")
    variances = np.load(os.path.join(root, "variances_mp.npy"))

    # FD Hessian of the UN-regularized data loss at the optimum, then add λ
    # with the intercept excluded (regularize_bias=False) — mirrors
    # _compute_variance's construction but derives H independently.
    from scipy.special import expit

    def data_loss(x):
        wq, b = x[:-1], x[-1]
        z = X @ wq + b
        per = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
        return np.sum(w * per)

    dim = D + 1
    eps = 1e-5
    H = np.zeros((dim, dim))
    for i in range(dim):
        for j in range(dim):
            e_i = np.eye(dim)[i] * eps
            e_j = np.eye(dim)[j] * eps
            H[i, j] = (data_loss(coeffs + e_i + e_j)
                       - data_loss(coeffs + e_i - e_j)
                       - data_loss(coeffs - e_i + e_j)
                       + data_loss(coeffs - e_i - e_j)) / (4 * eps * eps)
    lam = 0.7
    H += np.diag([lam + 1e-12] * dim)
    H[-1, -1] -= lam
    expected = np.diagonal(np.linalg.inv(H))
    np.testing.assert_allclose(variances, expected, rtol=1e-3)


def test_two_process_trainer_cli_env_contract(tmp_path):
    """The EXACT command + env the kubernetes Indexed-Job pods run:
    `python -m gdmix_tpu.gdmix` with COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID (k8s.py injects these; gdmix.py:run consumes them via
    maybe_initialize_distributed). Two pods over two files must reproduce the
    single-process oracle — proving the manifests actually distribute."""
    root = str(tmp_path)
    X, y, w = _write_dataset(root, [64, 48], seed=8)
    os.makedirs(os.path.join(root, "models_mp"), exist_ok=True)
    os.makedirs(os.path.join(root, "scores_mp"), exist_ok=True)
    cmd = [sys.executable, "-m", "gdmix_tpu.gdmix",
           "--action=train", "--stage=fixed_effect",
           "--model_type=logistic_regression",
           "--label_column_name=response", "--uid_column_name=uid",
           "--weight_column_name=weight",
           "--prediction_score_column_name=predictionScore",
           f"--metadata_file={os.path.join(root, 'tensor_metadata.json')}",
           f"--training_data_dir={os.path.join(root, 'trainingData')}",
           "--feature_bag=global",
           f"--feature_file={os.path.join(root, 'features.csv')}",
           f"--output_model_dir={os.path.join(root, 'models_mp')}",
           f"--training_score_dir={os.path.join(root, 'scores_mp')}",
           "--l2_reg_weight=0.7", "--regularize_bias=False",
           "--dtype=float64", "--lbfgs_tolerance=1e-14",
           "--lbfgs_pgtol=1e-10", "--num_of_lbfgs_iterations=500",
           "--sparsity_threshold=0.0"]
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    base_env.update(JAX_PLATFORMS="cpu", JAX_ENABLE_X64="true",
                    XLA_FLAGS="--xla_force_host_platform_device_count=2",
                    COORDINATOR_ADDRESS="127.0.0.1:9931", NUM_PROCESSES="2")
    procs = [subprocess.Popen(cmd, env=dict(base_env, PROCESS_ID=str(pid)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"pod {pid} failed:\n{outs[pid]}"
    (coeffs,) = load_linear_models_from_avro(
        os.path.join(root, "models_mp", "part-00000.avro"),
        os.path.join(root, "features.csv"))
    oracle = _scipy_fe_oracle(X, y, np.zeros(len(y)), w, lam=0.7,
                              regularize_bias=False)
    np.testing.assert_allclose(coeffs, oracle, atol=1e-6)
