"""Fixed-effect trainer tests vs a pure scipy oracle on the same synthetic TFRecord
data — the reference's backbone pattern (test_fixed_effect_lr_lbfgs_model.py:480-586)."""
import json
import os

import numpy as np
import pytest
from scipy.optimize import fmin_l_bfgs_b
from scipy.special import expit

from gdmix_tpu import constants
from gdmix_tpu.io import avro
from gdmix_tpu.io.feature_list import write_feature_list
from gdmix_tpu.io.input_pipeline import write_per_record
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.io.model_avro import load_linear_models_from_avro
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel
from gdmix_tpu.params import FixedLRParams, Params

D = 6       # features
N = 120     # samples


def _make_dataset(tmp_path, seed=0, with_offset=True, with_weight=True,
                  label_kind="binary", feature_bag="global"):
    rng = np.random.RandomState(seed)
    X = np.zeros((N, D))
    ragged_idx, ragged_val = [], []
    for i in range(N):
        nnz = rng.randint(1, D)
        cols = np.sort(rng.choice(D, nnz, replace=False))
        vals = rng.randn(nnz)
        X[i, cols] = vals
        ragged_idx.append(cols)
        ragged_val.append(vals)
    w_true = rng.randn(D)
    z = X @ w_true
    if label_kind == "binary":
        y = (rng.rand(N) < expit(z)).astype(np.int64)
    else:
        y = z + 0.1 * rng.randn(N)
    offsets = 0.3 * rng.randn(N) if with_offset else np.zeros(N)
    weights = (rng.rand(N) + 0.5) if with_weight else np.ones(N)

    features = [
        {"name": feature_bag, "dtype": "float", "shape": [D], "isSparse": True},
        {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
    ]
    columns = {"uid": np.arange(N, dtype=np.int64)}
    if with_weight:
        features.append({"name": "weight", "dtype": "float", "shape": [],
                         "isSparse": False})
        columns["weight"] = weights.astype(np.float32)
    if with_offset:
        features.append({"name": "offset", "dtype": "float", "shape": [],
                         "isSparse": False})
        columns["offset"] = offsets.astype(np.float32)
    label_dtype = "int" if label_kind == "binary" else "float"
    md_json = {"features": features,
               "labels": [{"name": "response", "dtype": label_dtype, "shape": [],
                           "isSparse": False}],
               "numberOfTrainingSamples": N}
    columns["response"] = y if label_kind == "binary" else y.astype(np.float32)

    root = str(tmp_path)
    train_dir = os.path.join(root, "trainingData")
    os.makedirs(train_dir, exist_ok=True)
    md_file = os.path.join(root, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump(md_json, f)
    metadata = DatasetMetadata.from_file(md_file)
    write_per_record(os.path.join(train_dir, "data.tfrecord"), metadata, columns,
                     feature_bag, ragged_idx, ragged_val)
    feature_file = os.path.join(root, "features.csv")
    write_feature_list([(f"f{i}", "") for i in range(D)], feature_file)

    # reload offsets/weights as f32 (what the file carries) for the oracle
    off32 = offsets.astype(np.float32).astype(np.float64)
    wt32 = weights.astype(np.float32).astype(np.float64)
    return {"root": root, "train_dir": train_dir, "md_file": md_file,
            "feature_file": feature_file, "X": X, "y": np.asarray(y, np.float64),
            "offsets": off32, "weights": wt32, "metadata": metadata}


def _scipy_fe_oracle(X, y, offsets, weights, lam, model_type="logistic_regression",
                     regularize_bias=True, has_intercept=True, x0=None):
    dim = X.shape[1] + (1 if has_intercept else 0)

    def val_grad(x):
        w, b = (x[:-1], x[-1]) if has_intercept else (x, 0.0)
        z = X @ w + offsets + b
        if model_type == "linear_regression":
            per = (y - z) ** 2
            dz = 2 * (z - y)
        else:
            per = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
            dz = expit(z) - y
        v = np.sum(weights * per)
        r = weights * dz
        g = np.concatenate([X.T @ r, [r.sum()]]) if has_intercept else X.T @ r
        mask = np.ones(dim)
        if has_intercept and not regularize_bias:
            mask[-1] = 0
        v += 0.5 * lam * np.sum(mask * x * x)
        g = g + lam * mask * x
        return v, g

    x, f, info = fmin_l_bfgs_b(val_grad, x0 if x0 is not None else np.zeros(dim),
                               m=10, factr=10.0, pgtol=1e-10, maxiter=500)
    return x


def _params(ds, tmp_path, **overrides):
    model_type = overrides.pop("model_type_", "logistic_regression")
    model_dir = os.path.join(ds["root"], "models")
    os.makedirs(model_dir, exist_ok=True)
    base = dict(metadata_file=ds["md_file"], output_model_dir=model_dir,
                training_data_dir=ds["train_dir"], feature_bag="global",
                feature_file=ds["feature_file"], l2_reg_weight=0.7,
                regularize_bias=False, dtype="float64", lbfgs_tolerance=1e-14, lbfgs_pgtol=1e-10,
                num_of_lbfgs_iterations=500, sparsity_threshold=0.0)
    base.update(overrides)
    model_params = FixedLRParams(**base)
    score_dir = os.path.join(ds["root"], "train_scores")
    vscore_dir = os.path.join(ds["root"], "validation_scores")
    base_params = Params(action="train", stage="fixed_effect",
                         model_type=model_type,
                         label_column_name="response", uid_column_name="uid",
                         weight_column_name="weight",
                         prediction_score_column_name="predictionScore",
                         training_score_dir=score_dir,
                         validation_score_dir=vscore_dir)
    return model_params, base_params


def _train(ds, tmp_path, **over):
    model_params, base_params = _params(ds, tmp_path, **over)
    model = FixedEffectLRModel(model_params, base_params)
    ctx = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
           constants.IS_CHIEF: True}
    model.train(model_params.training_data_dir, model_params.validation_data_dir,
                ds["md_file"], model_params.output_model_dir, ctx, base_params)
    return model


def test_train_matches_scipy_with_offset_and_weight(tmp_path):
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=0.7, regularize_bias=False)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=1e-6)

    # model avro round-trips with intercept at the end
    (loaded,) = load_linear_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"), ds["feature_file"])
    np.testing.assert_allclose(loaded, model.model_coefficients, atol=1e-12)


def test_train_no_offset(tmp_path):
    ds = _make_dataset(tmp_path, with_offset=False)
    model = _train(ds, tmp_path)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], np.zeros(N), ds["weights"],
                              lam=0.7, regularize_bias=False)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=1e-6)


def test_train_scores_output(tmp_path):
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path)
    _, base_params = _params(ds, tmp_path)
    got = read_scores(base_params.training_score_dir, base_params)
    w, b = model.model_coefficients[:-1], model.model_coefficients[-1]
    z_pc = ds["X"] @ w + b
    z_total = z_pc + ds["offsets"]
    order = np.argsort(got["uid"])
    np.testing.assert_allclose(got["predictionScorePerCoordinate"][order], z_pc,
                               atol=1e-5)
    np.testing.assert_allclose(got["predictionScore"][order], z_total, atol=1e-5)
    np.testing.assert_allclose(got["response"][order], ds["y"])


def test_warm_start_converged_is_stable(tmp_path):
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path)
    first = model.model_coefficients.copy()
    # Second run loads the saved avro and must stay at the optimum in 1 iteration.
    model2 = _train(ds, tmp_path, num_of_lbfgs_iterations=1)
    np.testing.assert_allclose(model2.model_coefficients, first, atol=1e-7)


def test_intercept_only_model(tmp_path):
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path, feature_bag=None, feature_file=None,
                   l2_reg_weight=0.0)
    # oracle: logistic regression with only an intercept
    oracle = _scipy_fe_oracle(np.zeros((N, 0)), ds["y"], ds["offsets"],
                              ds["weights"], lam=0.0)
    np.testing.assert_allclose(model.model_coefficients[-1], oracle[-1], atol=1e-6)


def test_no_intercept(tmp_path):
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path, has_intercept=False, regularize_bias=False)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=0.7, has_intercept=False)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=1e-6)


def test_linear_regression(tmp_path):
    ds = _make_dataset(tmp_path, label_kind="real")
    model = _train(ds, tmp_path, model_type_="linear_regression")
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=0.7, model_type="linear_regression",
                              regularize_bias=False)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=1e-5)


def test_variance_simple_and_full(tmp_path):
    """Variance oracle: direct numpy Hessian at the optimum
    (reference checks against statsmodels; we use the closed form it equals)."""
    ds = _make_dataset(tmp_path, with_weight=False)
    for mode in ("simple", "full"):
        model = _train(ds, tmp_path, fixed_effect_variance_mode=mode,
                       l2_reg_weight=0.0, regularize_bias=False)
        x = model.model_coefficients
        X1 = np.hstack([ds["X"], np.ones((N, 1))])
        rho = expit(X1 @ x + ds["offsets"])
        dvec = rho * (1 - rho)
        H = X1.T @ (X1 * dvec[:, None])
        if mode == "simple":
            expected = 1.0 / (np.diag(H) + 1e-12)
        else:
            expected = np.diagonal(np.linalg.inv(H + 1e-12 * np.eye(D + 1)))
        np.testing.assert_allclose(model.variances, expected, rtol=1e-3)


def test_thresholding(tmp_path):
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path, sparsity_threshold=10.0)  # absurd: zero everything
    assert np.all(model.model_coefficients == 0.0)


def test_predict_mode(tmp_path):
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path)
    model_params, base_params = _params(ds, tmp_path)
    out_dir = os.path.join(ds["root"], "inference_out")
    fresh = FixedEffectLRModel(model_params, base_params)
    fresh.predict(out_dir, ds["train_dir"], ds["md_file"],
                  model_params.output_model_dir,
                  {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1}, base_params)
    got = read_scores(out_dir, base_params)
    assert len(got["uid"]) == N
    w, b = model.model_coefficients[:-1], model.model_coefficients[-1]
    order = np.argsort(got["uid"])
    np.testing.assert_allclose(got["predictionScorePerCoordinate"][order],
                               ds["X"] @ w + b, atol=1e-5)


def test_effective_grad_mode_auto_resolution():
    """auto resolves to the concrete strategy: block in
    (block_min_features, block_max_features], onehot at/below
    onehot_max_features, hybrid beyond block's ceiling (whose builder
    degrades to scatter when the data has no hot set). Explicit modes pass
    through."""
    from gdmix_tpu.models.fixed_effect_lr import effective_grad_mode
    assert effective_grad_mode("auto", 10_000, 1024, 16384) == "block"
    assert effective_grad_mode("auto", 1024, 1024, 16384) == "onehot"
    assert effective_grad_mode("auto", 50, 1024, 16384) == "onehot"
    # degenerate config: past both ceilings -> hybrid
    assert effective_grad_mode("auto", 18_000, 20_000, 16384) == "hybrid"
    # wide-D regime: block's O(D) cost crosses the D-independent paths
    assert effective_grad_mode("auto", 100_000, 1024, 16384) == "block"
    assert effective_grad_mode("auto", 700_000, 1024, 16384) == "block"
    assert effective_grad_mode("auto", 700_001, 1024, 16384) == "hybrid"
    assert effective_grad_mode("auto", 10_000_000, 1024, 16384) == "hybrid"
    # the ceiling is a tunable (pin the parameter wiring)
    assert effective_grad_mode("auto", 2_000_000, 1024, 16384,
                               block_max_features=5_000_000) == "block"
    # segment is explicit-only; explicit modes are never overridden
    for m in ("block", "onehot", "scatter", "segment", "hybrid"):
        assert effective_grad_mode(m, 10_000, 1024, 16384) == m
