"""Random-effect batched trainer tests vs a per-entity scipy oracle — mirrors the
reference's test_random_effect_lr_lbfgs_model.py behavioral suite."""
import json
import os

import numpy as np
import pytest
from scipy.optimize import fmin_l_bfgs_b
from scipy.special import expit

from gdmix_tpu import constants
from gdmix_tpu.io.feature_list import write_feature_list
from gdmix_tpu.io.input_pipeline import EntityGroup, write_per_entity_grouped
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.io.model_avro import load_sparse_models_from_avro
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel
from gdmix_tpu.params import Params, REParams

D = 5  # global feature-space width


def _make_groups(num_entities=7, seed=0, entity_dtype="long", width=D,
                 max_support=None):
    """Ragged synthetic per-entity data with heterogeneous sizes/support.
    `width` is the global feature-space size (default the module D=5;
    pass >128 to land past newton_max_dim on the dense L-BFGS path)."""
    rng = np.random.RandomState(seed)
    max_support = max_support or width
    groups = []
    dense = {}
    uid = 0
    for e in range(num_entities):
        n = int(rng.randint(4, 20))
        support = np.sort(rng.choice(
            width, rng.randint(1, max_support + 1), replace=False))
        ragged_idx, ragged_val = [], []
        X = np.zeros((n, width))
        for r in range(n):
            nnz = rng.randint(1, len(support) + 1)
            cols = np.sort(rng.choice(support, nnz, replace=False))
            vals = rng.randn(nnz)
            ragged_idx.append(cols.astype(np.int64))
            ragged_val.append(vals)
            X[r, cols] = vals
        w_true = rng.randn(width)
        y = (rng.rand(n) < expit(X @ w_true)).astype(np.float64)
        # Degenerate single-class entities make the unregularized intercept
        # diverge (solver-dependent ridge) — force both classes present.
        if y.min() == y.max():
            y[0], y[-1] = 0.0, 1.0
        offsets = 0.2 * rng.randn(n).astype(np.float32).astype(np.float64)
        weights = (rng.rand(n) + 0.5).astype(np.float32).astype(np.float64)
        eid = str(e + 100)
        g = EntityGroup(
            entity_id=eid,
            columns={"uid": np.arange(uid, uid + n, dtype=np.int64),
                     "response": y,
                     "offset": offsets.astype(np.float32),
                     "weight": weights.astype(np.float32)},
            ragged_indices=ragged_idx, ragged_values=ragged_val)
        groups.append(g)
        dense[eid] = (X, y, offsets.astype(np.float32).astype(np.float64),
                      weights.astype(np.float32).astype(np.float64))
        uid += n
    return groups, dense


def _write_dataset(tmp_path, groups, entity_dtype="long", subdir="active",
                   width=D):
    root = str(tmp_path)
    md_json = {
        "features": [
            {"name": "per_entity", "dtype": "float", "shape": [width],
             "isSparse": True},
            {"name": "user_id", "dtype": entity_dtype, "shape": [], "isSparse": False},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "weight", "dtype": "float", "shape": [], "isSparse": False},
            {"name": "offset", "dtype": "float", "shape": [], "isSparse": False},
        ],
        "labels": [{"name": "response", "dtype": "float", "shape": [],
                    "isSparse": False}]}
    md_file = os.path.join(root, "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump(md_json, f)
    data_dir = os.path.join(root, "trainingData", subdir)
    os.makedirs(data_dir, exist_ok=True)
    metadata = DatasetMetadata.from_file(md_file)
    write_per_entity_grouped(os.path.join(data_dir, "data.tfrecord"), groups,
                             "user_id", entity_dtype, "per_entity")
    feature_file = os.path.join(root, "features.csv")
    write_feature_list([(f"f{i}", "") for i in range(width)], feature_file)
    return md_file, os.path.join(root, "trainingData"), feature_file


def _scipy_entity_oracle(X, y, offsets, weights, lam, support,
                         regularize_bias=False, theta0=None):
    """Reference BinaryLogisticRegressionTrainer.fit on the entity's support."""
    Xs = X[:, support]
    X1 = np.hstack([np.ones((len(y), 1)), Xs])
    n = len(y)

    def loss(t):
        z = X1 @ t + offsets
        ce = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
        reg = t[1:] @ t[1:] if not regularize_bias else t @ t
        return (np.sum(weights * ce) + 0.5 * lam * reg) / n

    def grad(t):
        z = X1 @ t + offsets
        g = X1.T @ (weights * (expit(z) - y)) + lam * t
        if not regularize_bias:
            g[0] -= lam * t[0]
        return g / n

    x0 = np.zeros(X1.shape[1]) if theta0 is None else theta0
    x, _, _ = fmin_l_bfgs_b(loss, x0, fprime=grad, m=10, factr=10.0,
                            pgtol=1e-10, maxiter=500)
    return x


def _build_model(md_file, train_dir, feature_file, tmp_path, **over):
    model_dir = os.path.join(str(tmp_path), "models")
    os.makedirs(model_dir, exist_ok=True)
    base = dict(metadata_file=md_file, output_model_dir=model_dir,
                training_data_dir=train_dir, feature_bag="per_entity",
                feature_file=feature_file, partition_entity="user_id",
                l2_reg_weight=0.6, regularize_bias=False, dtype="float64",
                lbfgs_tolerance=1e-14, lbfgs_pgtol=1e-10, num_of_lbfgs_iterations=500,
                sparsity_threshold=0.0)
    base.update(over)
    model_params = REParams(**base)
    base_params = Params(action="train", stage="random_effect",
                         model_type="logistic_regression",
                         label_column_name="response", uid_column_name="uid",
                         weight_column_name="weight",
                         prediction_score_column_name="predictionScore")
    return RandomEffectLRModel(model_params, base_params), base_params


def _ctx(tmp_path, partition=0):
    score_dir = os.path.join(str(tmp_path), "train_scores")
    vscore = os.path.join(str(tmp_path), "validation_scores")
    os.makedirs(score_dir, exist_ok=True)
    os.makedirs(vscore, exist_ok=True)
    return {
        constants.PARTITION_INDEX: partition,
        constants.ACTIVE_TRAINING_OUTPUT_FILE:
            os.path.join(score_dir, "part-00000-active.avro"),
        constants.PASSIVE_TRAINING_OUTPUT_FILE:
            os.path.join(score_dir, "part-00000-passive.avro"),
        constants.VALIDATION_OUTPUT_FILE: os.path.join(vscore, "part-00000.avro"),
    }


def test_train_matches_per_entity_scipy_oracle(tmp_path):
    groups, dense = _make_groups()
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(tmp_path), base_params)

    loaded = load_sparse_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"), feature_file)
    assert set(loaded) == set(dense)
    for eid, (X, y, offsets, weights) in dense.items():
        support = loaded[eid].unique_global_indices
        oracle = _scipy_entity_oracle(X, y, offsets, weights, 0.6, support)
        np.testing.assert_allclose(loaded[eid].theta, oracle, atol=2e-5,
                                   err_msg=f"entity {eid}")


def test_scoring_during_training_equals_cold_prediction(tmp_path):
    groups, dense = _make_groups(seed=2)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path)
    ctx = _ctx(tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, ctx, base_params)
    warm = read_scores(ctx[constants.ACTIVE_TRAINING_OUTPUT_FILE], base_params)

    # Cold predict with a freshly-constructed model object.
    model2, _ = _build_model(md_file, train_dir, feature_file, tmp_path)
    out_dir = os.path.join(str(tmp_path), "cold_out")
    model2.predict(out_dir, os.path.join(train_dir, "active"), md_file,
                   model.checkpoint_path, {constants.PARTITION_INDEX: 0},
                   base_params)
    cold = read_scores(out_dir, base_params)
    ow, oc = np.argsort(warm["uid"]), np.argsort(cold["uid"])
    np.testing.assert_allclose(warm["predictionScore"][ow],
                               cold["predictionScore"][oc], atol=1e-6)
    np.testing.assert_allclose(warm["predictionScorePerCoordinate"][ow],
                               cold["predictionScorePerCoordinate"][oc], atol=1e-6)


def test_warm_start_converged_unchanged_cold_start_differs(tmp_path):
    groups, dense = _make_groups(seed=4)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path)
    ctx = _ctx(tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, ctx, base_params)
    mf = os.path.join(model.checkpoint_path, "part-00000.avro")
    first = load_sparse_models_from_avro(mf, feature_file)

    # Warm start + 1 iteration → unchanged.
    model_w, _ = _build_model(md_file, train_dir, feature_file, tmp_path,
                              num_of_lbfgs_iterations=1)
    model_w.train(os.path.join(train_dir, "active"), None, md_file,
                  model_w.checkpoint_path, ctx, base_params)
    warm = load_sparse_models_from_avro(mf, feature_file)
    for eid in first:
        np.testing.assert_allclose(warm[eid].theta, first[eid].theta, atol=1e-7)

    # Cold start + 1 iteration → differs.
    os.remove(mf)
    model_c, _ = _build_model(md_file, train_dir, feature_file, tmp_path,
                              num_of_lbfgs_iterations=1)
    model_c.train(os.path.join(train_dir, "active"), None, md_file,
                  model_c.checkpoint_path, ctx, base_params)
    cold = load_sparse_models_from_avro(mf, feature_file)
    diffs = [np.max(np.abs(np.resize(cold[e].theta, first[e].theta.shape)
                           - first[e].theta)) for e in first]
    assert max(diffs) > 1e-3


@pytest.mark.parametrize("mode", ["simple", "full"])
def test_variance_matches_reference_formula(tmp_path, mode):
    groups, dense = _make_groups(seed=6, num_entities=4)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path,
                                      random_effect_variance_mode=mode,
                                      l2_reg_weight=0.0)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(tmp_path), base_params)
    loaded = load_sparse_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"), feature_file)
    for eid, (X, y, offsets, weights) in dense.items():
        sm = loaded[eid]
        Xs = X[:, sm.unique_global_indices]
        X1 = np.hstack([np.ones((len(y), 1)), Xs])
        rho = expit(X1 @ sm.theta + offsets)
        dvec = rho * (1 - rho) * weights
        H = X1.T @ (X1 * dvec[:, None])
        if mode == "simple":
            expected = 1.0 / (np.diag(H) + 1e-12)
        else:
            expected = np.diagonal(np.linalg.inv(H + 1e-12 * np.eye(H.shape[0])))
        np.testing.assert_allclose(sm.variance, expected, rtol=1e-3,
                                   err_msg=f"entity {eid}")


def test_unseen_entity_passes_offsets_through(tmp_path):
    groups, dense = _make_groups(seed=8, num_entities=3)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path)
    ctx = _ctx(tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, ctx, base_params)

    # Score a dataset containing an entity with no trained model.
    extra, _ = _make_groups(seed=9, num_entities=1)
    extra[0].entity_id = "99999"
    extra_dir = os.path.join(str(tmp_path), "trainingData", "extra")
    os.makedirs(extra_dir, exist_ok=True)
    write_per_entity_grouped(os.path.join(extra_dir, "data.tfrecord"), extra,
                             "user_id", "long", "per_entity")
    out_dir = os.path.join(str(tmp_path), "unseen_out")
    model.predict(out_dir, extra_dir, md_file, model.checkpoint_path,
                  {constants.PARTITION_INDEX: 0}, base_params)
    got = read_scores(out_dir, base_params)
    offs = extra[0].columns["offset"].astype(np.float64)
    order = np.argsort(got["uid"])
    np.testing.assert_allclose(got["predictionScore"][order],
                               offs[np.argsort(extra[0].columns["uid"])], atol=1e-6)
    np.testing.assert_allclose(got["predictionScorePerCoordinate"], 0.0, atol=1e-6)


def test_intercept_only_model(tmp_path):
    groups, dense = _make_groups(seed=10, num_entities=3)
    for g in groups:  # strip features
        g.ragged_indices = [np.zeros(0, np.int64) for _ in g.ragged_indices]
        g.ragged_values = [np.zeros(0) for _ in g.ragged_values]
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, None, tmp_path,
                                      feature_bag=None, l2_reg_weight=0.0)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(tmp_path), base_params)
    loaded = load_sparse_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"), None)
    for eid, (X, y, offsets, weights) in dense.items():
        oracle = _scipy_entity_oracle(np.zeros_like(X), y, offsets, weights, 0.0,
                                      np.zeros(0, np.int64))
        np.testing.assert_allclose(loaded[eid].theta[0], oracle[0], atol=1e-5)


def test_string_entity_ids(tmp_path):
    groups, dense = _make_groups(seed=12, num_entities=3)
    for g in groups:
        g.entity_id = f"user_{g.entity_id}"
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups,
                                                      entity_dtype="string")
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(tmp_path), base_params)
    loaded = load_sparse_models_from_avro(
        os.path.join(model.checkpoint_path, "part-00000.avro"), feature_file)
    assert set(loaded) == {f"user_{e}" for e in dense}


def test_prior_only_entities_carry_forward(tmp_path):
    """Entities present in the prior model but absent from the new dataset must
    survive into the new model file untouched (reference :155-163)."""
    groups, dense = _make_groups(seed=20, num_entities=4)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path)
    ctx = _ctx(tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, ctx, base_params)
    mf = os.path.join(model.checkpoint_path, "part-00000.avro")
    first = load_sparse_models_from_avro(mf, feature_file)

    # retrain on a dataset with only the first two entities
    sub = [g for g in groups if g.entity_id in ("100", "101")]
    sub_dir = os.path.join(str(tmp_path), "sub")
    os.makedirs(os.path.join(sub_dir, "active"), exist_ok=True)
    write_per_entity_grouped(os.path.join(sub_dir, "active", "d.tfrecord"),
                             sub, "user_id", "long", "per_entity")
    model2, _ = _build_model(md_file, train_dir, feature_file, tmp_path)
    model2.train(os.path.join(sub_dir, "active"), None, md_file,
                 model2.checkpoint_path, ctx, base_params)
    after = load_sparse_models_from_avro(mf, feature_file)
    assert set(after) == set(first)  # 102/103 carried forward
    for eid in ("102", "103"):
        np.testing.assert_allclose(after[eid].theta, first[eid].theta,
                                   atol=1e-12)
    for eid in ("100", "101"):   # retrained entities stay at optimum (warm)
        np.testing.assert_allclose(after[eid].theta, first[eid].theta,
                                   atol=1e-4)


def test_local_indexing_flag_output_equivalence(tmp_path):
    """enable_local_indexing True/False must produce identical models (the
    compact-space solver makes them equivalent by construction — this pins the
    claimed output-equivalence with the reference's two modes)."""
    groups, dense = _make_groups(seed=24)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    results = {}
    for flag in (False, True):
        mdir = os.path.join(str(tmp_path), f"models_{flag}")
        os.makedirs(mdir, exist_ok=True)
        model, base_params = _build_model(md_file, train_dir, feature_file,
                                          tmp_path, output_model_dir=mdir,
                                          enable_local_indexing=flag)
        model.train(os.path.join(train_dir, "active"), None, md_file,
                    model.checkpoint_path, _ctx(tmp_path), base_params)
        results[flag] = load_sparse_models_from_avro(
            os.path.join(mdir, "part-00000.avro"), feature_file)
    for eid in results[False]:
        np.testing.assert_allclose(results[False][eid].theta,
                                   results[True][eid].theta, atol=1e-12)
        np.testing.assert_array_equal(
            results[False][eid].unique_global_indices,
            results[True][eid].unique_global_indices)


def test_model_save_load_save_idempotent(tmp_path):
    """load -> save -> load of the photon-ml avro must be lossless (sparsity
    threshold 0)."""
    from gdmix_tpu.io.model_avro import export_linear_model_to_avro
    groups, dense = _make_groups(seed=26, num_entities=3)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file, tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, _ctx(tmp_path), base_params)
    mf = os.path.join(model.checkpoint_path, "part-00000.avro")
    first = load_sparse_models_from_avro(mf, feature_file)
    mf2 = os.path.join(str(tmp_path), "resaved.avro")
    export_linear_model_to_avro(
        list(first), [m.unique_global_indices for m in first.values()],
        [m.theta[1:] for m in first.values()],
        [m.theta[0] for m in first.values()],
        feature_file, mf2, sparsity_threshold=0.0)
    second = load_sparse_models_from_avro(mf2, feature_file)
    for eid in first:
        np.testing.assert_allclose(second[eid].theta, first[eid].theta,
                                   atol=1e-15)


@pytest.mark.parametrize("variance_mode", [constants.SIMPLE, constants.FULL])
def test_dense_lbfgs_solver_wide_support_oracle(variance_mode):
    """_lbfgs_dense_solver (the dense path for buckets past newton_max_dim) must
    match both the sparse vmapped L-BFGS and the scipy per-entity oracle at
    dim > 128, including SIMPLE/FULL variances (reference solver semantics:
    binary_logistic_regression.py:144-239)."""
    from gdmix_tpu.models.random_effect_lr import (_lbfgs_dense_solver,
                                                   _lbfgs_solver)
    rng = np.random.RandomState(5)
    B, n_cap, k, u_cap, lam = 3, 48, 6, 150, 0.7
    counts = np.array([40, 25, 33])
    # unique indices per record (records never list a feature twice; duplicate
    # ids would make the quadratic Hessian terms representation-dependent)
    indices = np.stack([
        np.stack([rng.choice(u_cap, k, replace=False) for _ in range(n_cap)])
        for _ in range(B)]).astype(np.int32)
    values = rng.randn(B, n_cap, k)
    labels = (rng.rand(B, n_cap) < 0.5).astype(np.float64)
    offsets = 0.1 * rng.randn(B, n_cap)
    weights = (rng.rand(B, n_cap) + 0.5)
    row_live = np.arange(n_cap)[None, :] < counts[:, None]
    # padding is inert by construction: pad rows carry weight 0, pad entries 0
    values *= row_live[:, :, None]
    weights *= row_live
    a = dict(theta0=np.zeros((B, u_cap + 1)), indices=indices, values=values,
             offsets=offsets * row_live, labels=labels * row_live,
             weights=weights, sample_count=counts.astype(np.float64))
    key = (u_cap, True, False, lam, 500, 1e-14, 1e-10, 10, variance_mode)
    th_d, var_d, conv_d = (np.asarray(t) for t in _lbfgs_dense_solver(*key)(a))
    th_s, var_s, conv_s = (np.asarray(t) for t in _lbfgs_solver(*key)(a))
    assert conv_d.all() and conv_s.all()
    np.testing.assert_allclose(th_d, th_s, atol=5e-6)
    np.testing.assert_allclose(var_d, var_s, rtol=1e-4, atol=1e-8)
    for e in range(B):
        X = np.zeros((int(counts[e]), u_cap))
        for r in range(int(counts[e])):
            np.add.at(X[r], indices[e, r], values[e, r])
        oracle = _scipy_entity_oracle(X, labels[e, :counts[e]],
                                      offsets[e, :counts[e]],
                                      weights[e, :counts[e]], lam,
                                      np.arange(u_cap))
        np.testing.assert_allclose(th_d[e], oracle, atol=2e-5,
                                   err_msg=f"entity {e}")


@pytest.mark.parametrize("variance_mode", [constants.SIMPLE, constants.FULL])
def test_dual_newton_solver_wide_support_oracle(variance_mode):
    """_newton_dual_solver (sample-space Newton, the auto path for wide buckets
    where samples-per-entity < dim) must match the sparse L-BFGS solver and the
    scipy per-entity oracle, including SIMPLE/FULL variances."""
    from gdmix_tpu.models.random_effect_lr import (_lbfgs_solver,
                                                   _newton_dual_solver)
    rng = np.random.RandomState(9)
    B, n_cap, k, u_cap, lam = 3, 48, 6, 150, 0.7
    counts = np.array([40, 25, 33])
    indices = np.stack([
        np.stack([rng.choice(u_cap, k, replace=False) for _ in range(n_cap)])
        for _ in range(B)]).astype(np.int32)
    values = rng.randn(B, n_cap, k)
    labels = (rng.rand(B, n_cap) < 0.5).astype(np.float64)
    offsets = 0.1 * rng.randn(B, n_cap)
    weights = (rng.rand(B, n_cap) + 0.5)
    row_live = np.arange(n_cap)[None, :] < counts[:, None]
    values *= row_live[:, :, None]
    weights *= row_live
    a = dict(theta0=np.zeros((B, u_cap + 1)), indices=indices, values=values,
             offsets=offsets * row_live, labels=labels * row_live,
             weights=weights, sample_count=counts.astype(np.float64))
    key = (u_cap, True, False, lam, 500, 1e-14, 1e-10, 10, variance_mode)
    th_d, var_d, conv_d = (np.asarray(t) for t in _newton_dual_solver(*key)(a))
    th_s, var_s, conv_s = (np.asarray(t) for t in _lbfgs_solver(*key)(a))
    assert conv_d.all() and conv_s.all()
    np.testing.assert_allclose(th_d, th_s, atol=5e-6)
    np.testing.assert_allclose(var_d, var_s, rtol=1e-4, atol=1e-8)
    for e in range(B):
        X = np.zeros((int(counts[e]), u_cap))
        for r in range(int(counts[e])):
            np.add.at(X[r], indices[e, r], values[e, r])
        oracle = _scipy_entity_oracle(X, labels[e, :counts[e]],
                                      offsets[e, :counts[e]],
                                      weights[e, :counts[e]], lam,
                                      np.arange(u_cap))
        np.testing.assert_allclose(th_d[e], oracle, atol=2e-5,
                                   err_msg=f"entity {e}")


def test_auto_solver_selects_dual_newton_for_wide_buckets(tmp_path):
    """batch_solver='auto' must route wide buckets (n_cap < dim past
    newton_max_dim) to the sample-space Newton solver and produce models equal
    to the forced-lbfgs run."""
    import gdmix_tpu.models.random_effect_lr as re_mod
    groups, dense = _make_groups(seed=31, num_entities=8, width=300)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups,
                                                      width=300)
    results = {}
    dual_calls = []
    orig = re_mod._newton_dual_solver

    def spy(*key):
        dual_calls.append(key)
        return orig(*key)

    for solver in ("auto", "lbfgs"):
        re_mod._newton_dual_solver = spy if solver == "auto" else orig
        try:
            model, base_params = _build_model(md_file, train_dir, feature_file,
                                              tmp_path, batch_solver=solver)
            results[solver] = model.fit_groups(groups, {}, base_params)
        finally:
            re_mod._newton_dual_solver = orig
    assert dual_calls, "auto never dispatched the dual Newton solver"
    assert set(results["auto"]) == set(results["lbfgs"])
    for eid in results["auto"]:
        np.testing.assert_allclose(results["auto"][eid].theta,
                                   results["lbfgs"][eid].theta, atol=5e-6,
                                   err_msg=f"entity {eid}")


def test_explicit_newton_dual_honored_when_n_exceeds_dim(tmp_path):
    """batch_solver=newton_dual must use the dual solver (not silently fall
    back to L-BFGS) even when samples-per-entity >= dim, and reach the same
    optimum as the auto ladder."""
    import gdmix_tpu.models.random_effect_lr as RE
    groups, _ = _make_groups(num_entities=6, seed=4)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    thetas = {}
    for solver in ("auto", "newton_dual"):
        model, base = _build_model(md_file, train_dir, feature_file, tmp_path,
                                   batch_solver=solver,
                                   newton_max_dim=0)  # keep plain newton off
        called = {}
        orig = RE._newton_dual_solver

        def spy(*a, **k):
            called["dual"] = True
            return orig(*a, **k)

        RE._newton_dual_solver = spy
        try:
            weights = model.fit_groups(groups, {}, base)
        finally:
            RE._newton_dual_solver = orig
        thetas[solver] = weights
        if solver == "newton_dual":
            # n (4-20) >= dim (6) for most buckets — dual must still run
            assert called.get("dual"), "explicit newton_dual not dispatched"
    for eid in thetas["auto"]:
        np.testing.assert_allclose(thetas["auto"][eid].theta,
                                   thetas["newton_dual"][eid].theta,
                                   rtol=1e-4, atol=1e-5)


def test_score_flat_matches_score_groups(tmp_path):
    """The columnar scorer must reproduce the bucketized group scorer
    (incl. model-less entities -> logits = offsets)."""
    groups, _ = _make_groups(num_entities=8, seed=6)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base = _build_model(md_file, train_dir, feature_file, tmp_path)
    weights = model.fit_groups(groups, {}, base)
    # drop some models to exercise the zero-row path
    weights = {k: v for i, (k, v) in enumerate(weights.items()) if i % 3}
    want = model.score_groups(groups, weights, base)

    from gdmix_tpu.io.input_pipeline import load_per_entity_grouped_flat
    fg = load_per_entity_grouped_flat(os.path.join(train_dir, "active"),
                                      model.metadata, "user_id", "per_entity")
    assert fg is not None
    got = model.score_flat(fg, weights, base)
    # align by uid (orders may differ between in-memory groups and file)
    ow, og = np.argsort(want["uid"]), np.argsort(got["uid"])
    np.testing.assert_array_equal(want["uid"][ow], got["uid"][og])
    np.testing.assert_allclose(want["total"][ow], got["total"][og],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(want["per_coordinate"][ow],
                               got["per_coordinate"][og],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(want["labels"][ow], got["labels"][og])


def test_two_phase_device_compaction_matches_single_phase(tmp_path):
    """newton_phase1_iters > 0 takes the DEVICE-side straggler compaction
    (one dispatch, lax.switch prefix ladder — no host round-trip) and must
    reproduce the single-phase Newton solution and the scipy oracle."""
    groups, dense = _make_groups(num_entities=90, seed=11)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)

    results = {}
    for phase1 in (0, 2):
        sub = os.path.join(str(tmp_path), f"p{phase1}")
        os.makedirs(sub, exist_ok=True)
        model, base_params = _build_model(md_file, train_dir, feature_file,
                                          sub, newton_phase1_iters=phase1,
                                          batch_solver="newton")
        model.train(os.path.join(train_dir, "active"), None, md_file,
                    model.checkpoint_path, _ctx(sub), base_params)
        results[phase1] = load_sparse_models_from_avro(
            os.path.join(model.checkpoint_path, "part-00000.avro"),
            feature_file)

    assert set(results[2]) == set(results[0]) == set(dense)
    for eid in dense:
        np.testing.assert_allclose(results[2][eid].theta,
                                   results[0][eid].theta, atol=1e-7,
                                   err_msg=f"entity {eid}")
    # spot-check a few entities against the reference math directly
    for eid in list(dense)[:5]:
        X, y, offsets, weights = dense[eid]
        support = results[2][eid].unique_global_indices
        oracle = _scipy_entity_oracle(X, y, offsets, weights, 0.6, support)
        np.testing.assert_allclose(results[2][eid].theta, oracle, atol=2e-5)


def test_two_phase_sharded_plane_matches_host(tmp_path):
    """The sharded device plane selects the same two-phase solver through
    _select_solver; sharded + two-phase must equal host + single-phase."""
    groups, dense = _make_groups(num_entities=90, seed=12)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)

    outs = {}
    for tag, over in (("host", dict(re_mode="host")),
                      ("sh2p", dict(re_mode="sharded",
                                    newton_phase1_iters=2,
                                    batch_solver="newton"))):
        sub = os.path.join(str(tmp_path), tag)
        os.makedirs(sub, exist_ok=True)
        model, base_params = _build_model(md_file, train_dir, feature_file,
                                          sub, **over)
        model.train(os.path.join(train_dir, "active"), None, md_file,
                    model.checkpoint_path, _ctx(sub), base_params)
        outs[tag] = load_sparse_models_from_avro(
            os.path.join(model.checkpoint_path, "part-00000.avro"),
            feature_file)

    assert set(outs["sh2p"]) == set(outs["host"])
    for eid in outs["host"]:
        np.testing.assert_array_equal(
            outs["sh2p"][eid].unique_global_indices,
            outs["host"][eid].unique_global_indices)
        np.testing.assert_allclose(outs["sh2p"][eid].theta,
                                   outs["host"][eid].theta, atol=1e-7,
                                   err_msg=f"entity {eid}")


def test_streamed_re_matches_eager(tmp_path, caplog):
    """stream_chunk_entities > 0 trains the partition in entity-complete
    chunks (out-of-core) and must reproduce the eager fit exactly."""
    import logging as _logging
    groups, dense = _make_groups(num_entities=23, seed=21)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)

    outs = {}
    for tag, over in (("eager", {}), ("stream", dict(stream_chunk_entities=4))):
        sub = os.path.join(str(tmp_path), tag)
        os.makedirs(sub, exist_ok=True)
        model, base_params = _build_model(md_file, train_dir, feature_file,
                                          sub, **over)
        with caplog.at_level(_logging.INFO, logger="gdmix_tpu.models.random_effect_lr"):
            caplog.clear()
            model.train(os.path.join(train_dir, "active"), None, md_file,
                        model.checkpoint_path, _ctx(sub), base_params)
        streamed_lines = [r for r in caplog.records
                          if "streamed RE fit" in r.getMessage()]
        if tag == "stream":  # the streamed path must actually run (6 chunks)
            assert streamed_lines and "6 chunks" in streamed_lines[0].getMessage()
        else:
            assert not streamed_lines
        outs[tag] = load_sparse_models_from_avro(
            os.path.join(model.checkpoint_path, "part-00000.avro"),
            feature_file)
    assert set(outs["stream"]) == set(outs["eager"]) == set(dense)
    for eid in dense:
        np.testing.assert_array_equal(
            outs["stream"][eid].unique_global_indices,
            outs["eager"][eid].unique_global_indices)
        np.testing.assert_allclose(outs["stream"][eid].theta,
                                   outs["eager"][eid].theta, atol=1e-9,
                                   err_msg=f"entity {eid}")


def test_streamed_re_warm_start_and_prior_carry(tmp_path):
    """Streaming honors the prior: converged entities stay put, and prior
    entities absent from the data carry forward (reference :155-163)."""
    groups, dense = _make_groups(num_entities=9, seed=22)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file,
                                      tmp_path, stream_chunk_entities=2)
    ctx = _ctx(tmp_path)
    model.train(os.path.join(train_dir, "active"), None, md_file,
                model.checkpoint_path, ctx, base_params)
    model_file = os.path.join(model.checkpoint_path, "part-00000.avro")
    first = load_sparse_models_from_avro(model_file, feature_file)

    # inject an extra prior-only model, rerun streamed: it must carry forward
    from gdmix_tpu.io.model_avro import SparseModel
    ghost = SparseModel(model_id="ghost", theta=np.array([0.5, -1.0]),
                        variance=None, unique_global_indices=np.array([2]))
    weights = dict(first)
    weights["ghost"] = ghost
    model._save_model(model_file, weights)
    model2, _ = _build_model(md_file, train_dir, feature_file, tmp_path,
                             stream_chunk_entities=2)
    model2.train(os.path.join(train_dir, "active"), None, md_file,
                 model2.checkpoint_path, ctx, base_params)
    second = load_sparse_models_from_avro(model_file, feature_file)
    assert set(second) == set(first) | {"ghost"}
    np.testing.assert_allclose(second["ghost"].theta, ghost.theta, atol=1e-12)
    for eid in first:  # warm-started from the converged fit: stays put
        np.testing.assert_allclose(second[eid].theta, first[eid].theta,
                                   atol=1e-6)
