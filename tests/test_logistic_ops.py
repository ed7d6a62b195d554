"""Logistic-objective oracle tests: our padded-sparse JAX objectives vs straight
numpy implementations of the reference's math (binary_logistic_regression.py,
fixed_effect_lr_lbfgs_model.py) and end-to-end fits vs scipy fmin_l_bfgs_b."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import fmin_l_bfgs_b
from scipy.special import expit

from gdmix_tpu.ops.lbfgs import lbfgs
from gdmix_tpu.ops.logistic import (
    SparseBatch, fixed_effect_value_and_grad, hessian_diag, hessian_full,
    per_entity_value_and_grad, predict_logits, sparse_matvec, sparse_rmatvec)


def _random_sparse(n=50, d=20, k=5, seed=0):
    """Random padded-COO batch plus its dense equivalent."""
    rng = np.random.RandomState(seed)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k))
    X = np.zeros((n, d))
    for i in range(n):
        nnz = rng.randint(1, k + 1)
        cols = rng.choice(d, size=nnz, replace=False)
        vals = rng.randn(nnz)
        indices[i, :nnz] = cols
        values[i, :nnz] = vals
        X[i, cols] = vals
    y = rng.randint(0, 2, n).astype(np.float64)
    offsets = 0.5 * rng.randn(n)
    weights = rng.rand(n) + 0.5
    return indices, values, X, y, offsets, weights


def _batch(indices, values, offsets, labels, weights):
    return SparseBatch(indices=jnp.asarray(indices), values=jnp.asarray(values),
                       offsets=jnp.asarray(offsets), labels=jnp.asarray(labels),
                       weights=jnp.asarray(weights))


def test_sparse_matvec_rmatvec():
    indices, values, X, *_ = _random_sparse()
    w = np.random.RandomState(1).randn(20)
    got = sparse_matvec(jnp.asarray(w), jnp.asarray(indices), jnp.asarray(values))
    np.testing.assert_allclose(np.asarray(got), X @ w, atol=1e-12)
    r = np.random.RandomState(2).randn(50)
    got_t = sparse_rmatvec(jnp.asarray(indices), jnp.asarray(values), jnp.asarray(r), 20)
    np.testing.assert_allclose(np.asarray(got_t), X.T @ r, atol=1e-12)


# --- reference per-entity math in numpy (binary_logistic_regression.py) --------

def _ref_pe_loss(theta, X1, y, weights, offsets, lam, regularize_bias, has_intercept):
    n = X1.shape[0]
    pred = X1 @ theta + offsets
    ce = np.maximum(pred, 0) - pred * y + np.log1p(np.exp(-np.abs(pred)))
    cost = weights * ce
    if has_intercept and not regularize_bias:
        reg = (lam / 2.0) * theta[1:] @ theta[1:]
    else:
        reg = (lam / 2.0) * theta @ theta
    return (cost.sum() + reg) / n


def _ref_pe_grad(theta, X1, y, weights, offsets, lam, regularize_bias, has_intercept):
    n = X1.shape[0]
    p = expit(X1 @ theta + offsets)
    g = X1.T @ (weights * (p - y)) + lam * theta
    if has_intercept and not regularize_bias:
        g[0] -= lam * theta[0]
    return g / n


@pytest.mark.parametrize("lam,reg_bias,intercept", [
    (0.0, False, True), (1.0, False, True), (1.0, True, True), (2.5, False, False)])
def test_per_entity_objective_matches_reference(lam, reg_bias, intercept):
    indices, values, X, y, offsets, weights = _random_sparse()
    d = 20
    X1 = np.hstack([np.ones((50, 1)), X]) if intercept else X
    theta = np.random.RandomState(3).randn(X1.shape[1])
    batch = _batch(indices, values, offsets, y, weights)
    v, g = per_entity_value_and_grad(
        jnp.asarray(theta), batch, d, has_intercept=intercept,
        regularize_bias=reg_bias, l2_reg_weight=lam)
    v_ref = _ref_pe_loss(theta, X1, y, weights, offsets, lam, reg_bias, intercept)
    g_ref = _ref_pe_grad(theta, X1, y, weights, offsets, lam, reg_bias, intercept)
    np.testing.assert_allclose(float(v), v_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), g_ref, atol=1e-12)


def test_padding_rows_are_inert():
    """Rows with weight 0 (padding) must not change value/grad/hessian, and
    sample_count must drive the 1/n normalization."""
    indices, values, X, y, offsets, weights = _random_sparse(n=30)
    batch = _batch(indices, values, offsets, y, weights)
    theta = jnp.asarray(np.random.RandomState(4).randn(21))
    v0, g0 = per_entity_value_and_grad(theta, batch, 20,
                                       sample_count=jnp.asarray(30.0))
    # pad 10 garbage rows with weight 0
    pad = lambda a, fill: np.concatenate([a, np.full((10,) + a.shape[1:], fill, a.dtype)])
    batch_p = _batch(pad(indices, 7), pad(values, 0.0), pad(offsets, 99.0),
                     pad(y, 1.0), pad(weights, 0.0))
    v1, g1 = per_entity_value_and_grad(theta, batch_p, 20,
                                       sample_count=jnp.asarray(30.0))
    np.testing.assert_allclose(float(v0), float(v1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), atol=1e-12)


# --- fixed-effect math (fixed_effect_lr_lbfgs_model.py:353-381) ----------------

def _ref_fe_value_grad(x, X, y, offsets, weights, lam, reg_bias, intercept,
                       model_type, num_workers=1):
    w, b = (x[:-1], x[-1]) if intercept else (x, 0.0)
    z = X @ w + offsets + b
    if model_type == "linear_regression":
        per = (y - z) ** 2
        dz = 2 * (z - y)
    else:
        per = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
        dz = expit(z) - y
    value = np.sum(weights * per)
    r = weights * dz
    grad = np.concatenate([X.T @ r, [np.sum(r)]]) if intercept else X.T @ r
    l2v = 0.5 * (x @ x) if (reg_bias or not intercept) else 0.5 * (x[:-1] @ x[:-1])
    gmask = np.ones_like(x)
    if intercept and not reg_bias:
        gmask[-1] = 0
    value += l2v * lam / num_workers
    grad = grad + lam / num_workers * gmask * x
    return value, grad


@pytest.mark.parametrize("model_type", ["logistic_regression", "linear_regression"])
@pytest.mark.parametrize("intercept,reg_bias", [(True, True), (True, False), (False, True)])
def test_fixed_effect_objective_matches_reference(model_type, intercept, reg_bias):
    indices, values, X, y, offsets, weights = _random_sparse(seed=5)
    if model_type == "linear_regression":
        y = np.random.RandomState(6).randn(50)
    dim = 21 if intercept else 20
    x = np.random.RandomState(7).randn(dim)
    batch = _batch(indices, values, offsets, y, weights)
    v, g = fixed_effect_value_and_grad(
        jnp.asarray(x), batch, 20, has_intercept=intercept,
        regularize_bias=reg_bias, l2_reg_weight=1.5, model_type=model_type,
        num_workers=2)
    v_ref, g_ref = _ref_fe_value_grad(x, X, y, offsets, weights, 1.5, reg_bias,
                                      intercept, model_type, num_workers=2)
    np.testing.assert_allclose(float(v), v_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), g_ref, atol=1e-10)


def test_fixed_effect_psum_over_mesh():
    """Sharded loss+grad with psum must equal the single-chip total."""
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    indices, values, X, y, offsets, weights = _random_sparse(n=64, seed=8)
    x = np.random.RandomState(9).randn(21)
    batch = _batch(indices, values, offsets, y, weights)
    v_ref, g_ref = fixed_effect_value_and_grad(jnp.asarray(x), batch, 20,
                                               l2_reg_weight=2.0)

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    shard_fn = shard_map(
        lambda xx, bb: fixed_effect_value_and_grad(
            xx, bb, 20, l2_reg_weight=2.0, num_workers=8, axis_name="data"),
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=(P(), P()),
    )
    v, g = jax.jit(shard_fn)(jnp.asarray(x), batch)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), atol=1e-10)


# --- end-to-end fit vs scipy oracle (reference test pattern) -------------------

def test_fit_matches_scipy_reference_trainer():
    """Solve the per-entity problem with our lbfgs and compare coefficients with a
    scipy fmin_l_bfgs_b run of the reference's exact objective."""
    indices, values, X, y, offsets, weights = _random_sparse(n=80, seed=10)
    X1 = np.hstack([np.ones((80, 1)), X])
    lam = 1.0

    args = (X1, y, weights, offsets, lam, False, True)
    x_scipy, _, _ = fmin_l_bfgs_b(
        _ref_pe_loss, np.zeros(21), fprime=_ref_pe_grad, args=args,
        m=10, factr=10.0, maxiter=400, pgtol=1e-10)

    batch = _batch(indices, values, offsets, y, weights)

    def fun(theta):
        return per_entity_value_and_grad(theta, batch, 20, has_intercept=True,
                                         regularize_bias=False, l2_reg_weight=lam)

    res = lbfgs(fun, jnp.zeros(21), ftol=1e-14, pgtol=1e-10, maxiter=200)
    np.testing.assert_allclose(np.asarray(res.x), x_scipy, atol=5e-5)


# --- variance/Hessian (binary_logistic_regression.py:144-189) ------------------

def test_hessian_diag_and_full():
    indices, values, X, y, offsets, weights = _random_sparse(seed=11)
    X1 = np.hstack([np.ones((50, 1)), X])
    theta = np.random.RandomState(12).randn(21)
    batch = _batch(indices, values, offsets, y, weights)

    rho = expit(X1 @ theta + offsets)
    dvec = rho * (1 - rho) * weights
    dX = X1 * dvec[:, None]
    H_ref = X1.T @ dX

    H_diag = hessian_diag(jnp.asarray(theta), batch, 20, has_intercept=True,
                          intercept_at_end=False)
    np.testing.assert_allclose(np.asarray(H_diag), np.diag(H_ref), atol=1e-10)

    H_full = hessian_full(jnp.asarray(theta), batch, 20, has_intercept=True,
                          intercept_at_end=False)
    np.testing.assert_allclose(np.asarray(H_full), H_ref, atol=1e-10)


def test_predict_logits_both_layouts():
    indices, values, X, y, offsets, weights = _random_sparse(seed=13)
    w = np.random.RandomState(14).randn(20)
    b = 0.7
    batch = _batch(indices, values, offsets, y, weights)
    z_ref = X @ w + offsets + b
    z_re = predict_logits(jnp.asarray(np.concatenate([[b], w])), batch,
                          has_intercept=True, intercept_at_end=False)
    z_fe = predict_logits(jnp.asarray(np.concatenate([w, [b]])), batch,
                          has_intercept=True, intercept_at_end=True)
    np.testing.assert_allclose(np.asarray(z_re), z_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(z_fe), z_ref, atol=1e-12)


def test_sorted_coo_gradient_equivalence():
    """sorted-COO segment-sum gradient == scatter-add gradient."""
    from gdmix_tpu.ops.logistic import make_sorted_coo
    indices, values, X, y, offsets, weights = _random_sparse(n=40, seed=21)
    x = np.random.RandomState(22).randn(21)
    batch = _batch(indices, values, offsets, y, weights)
    coo = make_sorted_coo(indices, values)
    v1, g1 = fixed_effect_value_and_grad(jnp.asarray(x), batch, 20)
    v2, g2 = fixed_effect_value_and_grad(jnp.asarray(x), batch, 20,
                                         sorted_coo=coo)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-12)


# --- two-level one-hot ("block") fixed-effect path ------------------------------

@pytest.mark.parametrize("model_type", ["logistic_regression",
                                        "linear_regression"])
@pytest.mark.parametrize("has_intercept", [True, False])
def test_block_grad_matches_reference_path(model_type, has_intercept):
    """fixed_effect_value_and_grad_block ≡ fixed_effect_value_and_grad on the
    data term, at a feature count that is NOT a multiple of the lane width and
    with a batch needing chunking."""
    from gdmix_tpu.ops.logistic import fixed_effect_value_and_grad_block
    d = 300  # 2 hi-blocks + remainder (lane=128)
    n, k = 96, 7
    indices, values, X, y, offsets, weights = _random_sparse(n=n, d=d, k=k,
                                                             seed=11)
    if model_type == "linear_regression":
        y = y + 0.3 * np.random.RandomState(3).randn(n)
    batch = _batch(indices, values, offsets, y, weights)
    dim = d + (1 if has_intercept else 0)
    x = jnp.asarray(np.random.RandomState(4).randn(dim))

    v_ref, g_ref = fixed_effect_value_and_grad(
        x, batch, d, has_intercept=has_intercept, regularize_bias=True,
        l2_reg_weight=0.0, model_type=model_type)
    v_blk, g_blk = jax.jit(
        lambda xx, bb: fixed_effect_value_and_grad_block(
            xx, bb, d, chunk=32, has_intercept=has_intercept,
            model_type=model_type))(x, batch)
    np.testing.assert_allclose(float(v_blk), float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_blk), np.asarray(g_ref),
                               atol=1e-10)


def test_block_bf16x2_matches_reference_path():
    """precision="bf16x2" (exact two-term bf16 splits, single-pass dots) stays
    within ~2^-17 relative of the f32 reference data term — the fast block
    mode must not degrade gradients beyond L-BFGS tolerance."""
    from gdmix_tpu.ops.logistic import fixed_effect_value_and_grad_block
    d, n, k = 300, 96, 7
    indices, values, X, y, offsets, weights = _random_sparse(n=n, d=d, k=k,
                                                             seed=13)
    batch = _batch(indices, values, offsets, y, weights)
    x = jnp.asarray(np.random.RandomState(5).randn(d + 1), jnp.float32)
    batch32 = type(batch)(*[a.astype(jnp.float32)
                            if a.dtype.kind == "f" else a for a in batch])

    v_ref, g_ref = fixed_effect_value_and_grad(
        x, batch32, d, regularize_bias=True, l2_reg_weight=0.0)
    v_sp, g_sp = jax.jit(
        lambda xx, bb: fixed_effect_value_and_grad_block(
            xx, bb, d, chunk=32, precision="bf16x2"))(x, batch32)
    np.testing.assert_allclose(float(v_sp), float(v_ref), rtol=3e-5)
    scale = np.max(np.abs(np.asarray(g_ref)))
    np.testing.assert_allclose(np.asarray(g_sp), np.asarray(g_ref),
                               atol=3e-5 * scale)


def test_segment_grad_model_fit_matches_oracle(tmp_path):
    """End-to-end FE fit with grad_mode=segment (in-graph sorted-COO +
    segment_sum — the D-independent wide-feature-space strategy) equals the
    scipy oracle."""
    from tests.test_fixed_effect_lr import (_make_dataset, _params,
                                            _scipy_fe_oracle)
    from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu import constants
    ds = _make_dataset(tmp_path, seed=23)
    model_params, base_params = _params(ds, tmp_path, grad_mode="segment")
    model = FixedEffectLRModel(model_params, base_params)
    model.train(ds["train_dir"], None, ds["md_file"], model.checkpoint_path,
                {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
                 constants.IS_CHIEF: True}, base_params)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=model_params.l2_reg_weight,
                              regularize_bias=model_params.regularize_bias)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=1e-6)


def test_block_grad_model_fit_matches_oracle(tmp_path):
    """End-to-end FE fit with grad_mode=block equals the scipy oracle."""
    from tests.test_fixed_effect_lr import (_make_dataset, _params,
                                            _scipy_fe_oracle)
    from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu import constants
    ds = _make_dataset(tmp_path, seed=21)
    model_params, base_params = _params(ds, tmp_path, grad_mode="block",
                                        block_chunk_size=32)
    model = FixedEffectLRModel(model_params, base_params)
    model.train(ds["train_dir"], None, ds["md_file"], model.checkpoint_path,
                {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
                 constants.IS_CHIEF: True}, base_params)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=model_params.l2_reg_weight,
                              regularize_bias=model_params.regularize_bias)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=1e-6)


def _zipf_sparse(n=512, d=300, k=6, seed=0):
    """Power-law (Zipf s=1) padded-COO batch — the wide-D hybrid's regime."""
    rng = np.random.RandomState(seed)
    u = rng.rand(n, k)
    indices = (np.minimum(np.exp(u * np.log(d)).astype(int), d) - 1) \
        .astype(np.int32)
    values = rng.randn(n, k)
    values[rng.rand(n, k) < 0.2] = 0.0     # padding entries (inert)
    y = rng.randint(0, 2, n).astype(np.float64)
    offsets = 0.1 * rng.randn(n)
    weights = rng.rand(n) + 0.5
    return indices, values, offsets, y, weights


@pytest.mark.parametrize("model_type,has_intercept",
                         [("logistic_regression", True),
                          ("logistic_regression", False),
                          ("linear_regression", True)])
def test_hybrid_grad_matches_reference_path(model_type, has_intercept):
    """fixed_effect_value_and_grad_hybrid (hot/cold split)
    ≡ fixed_effect_value_and_grad on the data term, with BOTH sides active
    (small hot set on power-law ids → real cold tail)."""
    from gdmix_tpu.ops.logistic import (build_hybrid_aux,
                                        fixed_effect_value_and_grad_hybrid)
    d, n, k = 300, 512, 6
    indices, values, offsets, y, weights = _zipf_sparse(n=n, d=d, k=k, seed=31)
    if model_type == "linear_regression":
        y = y + 0.3 * np.random.RandomState(3).randn(n)
    batch = _batch(indices, values, offsets, y, weights)
    aux = build_hybrid_aux(batch.indices, batch.values, d, hot_features=32,
                           cold_max_frac=0.9)
    assert aux is not None
    # both sides genuinely active
    assert int(np.sum(np.asarray(aux.cold_val) != 0)) > 0
    dim = d + (1 if has_intercept else 0)
    x = jnp.asarray(np.random.RandomState(4).randn(dim))

    v_ref, g_ref = fixed_effect_value_and_grad(
        x, batch, d, has_intercept=has_intercept, regularize_bias=True,
        l2_reg_weight=0.0, model_type=model_type)
    v_hy, g_hy = jax.jit(
        lambda xx, bb, ax: fixed_effect_value_and_grad_hybrid(
            xx, bb, ax, d, chunk=128, has_intercept=has_intercept,
            model_type=model_type))(x, batch, aux)
    np.testing.assert_allclose(float(v_hy), float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_hy), np.asarray(g_ref),
                               atol=1e-10)


def test_hybrid_builder_edges():
    """All-hot (A ≥ distinct ids → empty cold side) stays exact; hot-set-free
    data (uniform ids vs a tiny A) makes the builder DECLINE — the
    data-driven fallback to scatter, so auto is never worse than scatter."""
    from gdmix_tpu.ops.logistic import (build_hybrid_aux,
                                        fixed_effect_value_and_grad_hybrid)
    d, n, k = 300, 256, 5
    indices, values, offsets, y, weights = _zipf_sparse(n=n, d=d, k=k, seed=7)
    batch = _batch(indices, values, offsets, y, weights)
    # A >= D: everything hot, cold arrays are pure padding
    aux = build_hybrid_aux(batch.indices, batch.values, d,
                           hot_features=10_000, cold_max_frac=0.9)
    assert aux is not None
    assert int(np.sum(np.asarray(aux.cold_val) != 0)) == 0
    x = jnp.asarray(np.random.RandomState(1).randn(d + 1))
    v_ref, g_ref = fixed_effect_value_and_grad(
        x, batch, d, regularize_bias=True, l2_reg_weight=0.0)
    v_hy, g_hy = fixed_effect_value_and_grad_hybrid(x, batch, aux, d,
                                                    chunk=128)
    np.testing.assert_allclose(float(v_hy), float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_hy), np.asarray(g_ref),
                               atol=1e-10)
    # uniform ids, tiny hot budget → decline
    rng = np.random.RandomState(2)
    uni = batch._replace(indices=jnp.asarray(
        rng.randint(0, d, (n, k)), jnp.int32))
    assert build_hybrid_aux(uni.indices, uni.values, d, hot_features=8,
                            cold_max_frac=0.3) is None


def test_hybrid_grad_over_mesh_matches_host():
    """The hybrid's GSPMD story: batch + split arrays sharded over the
    8-device mesh produce the same (value, grad) as unsharded."""
    from gdmix_tpu.ops.logistic import (build_hybrid_aux,
                                        fixed_effect_value_and_grad_hybrid)
    from gdmix_tpu.parallel.mesh import (batch_sharding, get_mesh, replicated)
    d, n, k = 300, 512, 6
    indices, values, offsets, y, weights = _zipf_sparse(n=n, d=d, k=k, seed=5)
    batch = _batch(indices, values, offsets, y, weights)
    x = jnp.asarray(np.random.RandomState(8).randn(d + 1))
    aux_host = build_hybrid_aux(batch.indices, batch.values, d,
                                hot_features=32, cold_max_frac=0.9)
    v_ref, g_ref = fixed_effect_value_and_grad_hybrid(x, batch, aux_host, d,
                                                      chunk=128)

    mesh = get_mesh()
    ndev = len(mesh.devices.flatten())
    assert ndev == 8
    bsh, bsh2 = batch_sharding(mesh), batch_sharding(mesh, rank=2)
    sharded = SparseBatch(jax.device_put(batch.indices, bsh2),
                          jax.device_put(batch.values, bsh2),
                          jax.device_put(batch.offsets, bsh),
                          jax.device_put(batch.labels, bsh),
                          jax.device_put(batch.weights, bsh))
    aux = build_hybrid_aux(sharded.indices, sharded.values, d,
                           hot_features=32, cold_max_frac=0.9,
                           pad_multiple=ndev * 8,
                           shardings=(replicated(mesh), bsh2, bsh))
    v_sh, g_sh = jax.jit(
        lambda xx, bb, ax: fixed_effect_value_and_grad_hybrid(
            xx, bb, ax, d, chunk=64))(
        jax.device_put(x, replicated(mesh)), sharded, aux)
    np.testing.assert_allclose(float(v_sh), float(v_ref), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g_sh), np.asarray(g_ref),
                               atol=1e-9)


def test_hybrid_grad_model_fit_matches_oracle(tmp_path):
    """End-to-end FE fit with grad_mode=hybrid (small hot set → both sides
    active) equals the scipy oracle."""
    from tests.test_fixed_effect_lr import (_make_dataset, _params,
                                            _scipy_fe_oracle)
    from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu import constants
    ds = _make_dataset(tmp_path, seed=29)
    model_params, base_params = _params(ds, tmp_path, grad_mode="hybrid",
                                        hot_features=6,
                                        hybrid_cold_max_frac=1.0,
                                        block_chunk_size=32)
    model = FixedEffectLRModel(model_params, base_params)
    model.train(ds["train_dir"], None, ds["md_file"], model.checkpoint_path,
                {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
                 constants.IS_CHIEF: True}, base_params)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=model_params.l2_reg_weight,
                              regularize_bias=model_params.regularize_bias)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=1e-6)


def test_hybrid_adaptive_hot_size():
    """hot_features=0 picks the hot-set size from the batch's own frequency
    profile via the measured cost model: a steeper distribution must choose
    a hot set no bigger than a flatter one's, the choice is a pow-2
    candidate, and the split stays exact."""
    from gdmix_tpu.ops.logistic import (_HYBRID_A_CANDIDATES,
                                        build_hybrid_aux,
                                        fixed_effect_value_and_grad_hybrid)
    d, n, k = 300_000, 4096, 8
    rng = np.random.RandomState(2)

    def zipf_batch(s):
        u = rng.rand(n, k)
        a = 1.0 - s
        idx = ((1.0 + u * (float(d) ** a - 1.0)) ** (1.0 / a)).astype(int)
        idx = np.clip(idx - 1, 0, d - 1).astype(np.int32)
        vals = rng.randn(n, k)
        return _batch(idx, vals, 0.1 * rng.randn(n),
                      rng.randint(0, 2, n).astype(float), np.ones(n))

    steep = zipf_batch(1.6)
    flat = zipf_batch(1.05)
    aux_s = build_hybrid_aux(steep.indices, steep.values, d, hot_features=0,
                             cold_max_frac=1.0)
    aux_f = build_hybrid_aux(flat.indices, flat.values, d, hot_features=0,
                             cold_max_frac=1.0)
    assert aux_s is not None and aux_f is not None
    a_s, a_f = aux_s.hot_ids.shape[0], aux_f.hot_ids.shape[0]
    assert a_s in _HYBRID_A_CANDIDATES and a_f in _HYBRID_A_CANDIDATES
    assert a_s <= a_f, (a_s, a_f)
    # exactness is independent of the chosen size
    x = jnp.asarray(np.random.RandomState(5).randn(d + 1) * 0.1)
    v_ref, g_ref = fixed_effect_value_and_grad(
        x, steep, d, regularize_bias=True, l2_reg_weight=0.0)
    v_hy, g_hy = jax.jit(
        lambda xx, bb, ax: fixed_effect_value_and_grad_hybrid(
            xx, bb, ax, d, chunk=512))(x, steep, aux_s)
    np.testing.assert_allclose(float(v_hy), float(v_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_hy), np.asarray(g_ref),
                               atol=1e-9)
