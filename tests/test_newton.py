"""Batched Newton solver tests: must reach the same optimum as scipy and as the
L-BFGS path (the two RE solver backends are interchangeable)."""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import fmin_l_bfgs_b
from scipy.special import expit

from gdmix_tpu.ops.newton import densify_bucket, newton_lr_batch


def _problems(B=12, n=30, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(B, n, d) * (rng.rand(B, n, d) < 0.6)
    w_true = rng.randn(B, d)
    z = np.einsum("bnd,bd->bn", X, w_true)
    y = (rng.rand(B, n) < expit(z)).astype(np.float64)
    # ensure both classes per lane (avoid unregularized-intercept ridges)
    y[:, 0], y[:, -1] = 0.0, 1.0
    offsets = 0.2 * rng.randn(B, n)
    weights = rng.rand(B, n) + 0.5
    return X, y, offsets, weights


def _scipy_opt(X1, y, offsets, weights, lam, reg_bias):
    n = len(y)

    def loss(t):
        z = X1 @ t + offsets
        ce = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
        reg = t @ t if reg_bias else t[1:] @ t[1:]
        return (np.sum(weights * ce) + 0.5 * lam * reg) / n

    def grad(t):
        z = X1 @ t + offsets
        g = X1.T @ (weights * (expit(z) - y)) + lam * t
        if not reg_bias:
            g[0] -= lam * t[0]
        return g / n

    x, _, _ = fmin_l_bfgs_b(loss, np.zeros(X1.shape[1]), fprime=grad,
                            factr=10.0, pgtol=1e-12, maxiter=500)
    return x


@pytest.mark.parametrize("lam,reg_bias", [(0.5, False), (0.0, False), (1.0, True)])
def test_newton_matches_scipy(lam, reg_bias):
    B, n, d = 12, 30, 6
    X, y, offsets, weights = _problems(B, n, d)
    ones = np.ones((B, n, 1))
    X1 = np.concatenate([ones, X], axis=2)
    l2_mask = np.ones(d + 1)
    if not reg_bias:
        l2_mask[0] = 0.0
    res = newton_lr_batch(
        jnp.zeros((B, d + 1)), jnp.asarray(X1), jnp.asarray(y),
        jnp.asarray(weights), jnp.asarray(offsets),
        jnp.full((B,), n, jnp.float64),
        l2_reg_weight=lam, l2_mask=jnp.asarray(l2_mask),
        maxiter=50, ftol=1e-14, pgtol=1e-10)
    assert bool(jnp.all(res.converged))
    for b in range(B):
        oracle = _scipy_opt(X1[b], y[b], offsets[b], weights[b], lam, reg_bias)
        np.testing.assert_allclose(np.asarray(res.theta[b]), oracle, atol=3e-5,
                                   err_msg=f"lane {b}")


def test_newton_fast_iteration_count():
    B, n, d = 8, 40, 5
    X, y, offsets, weights = _problems(B, n, d, seed=2)
    ones = np.ones((B, n, 1))
    X1 = np.concatenate([ones, X], axis=2)
    res = newton_lr_batch(
        jnp.zeros((B, d + 1)), jnp.asarray(X1), jnp.asarray(y),
        jnp.asarray(weights), jnp.asarray(offsets),
        jnp.full((B,), n, jnp.float64),
        l2_reg_weight=1.0, l2_mask=jnp.ones(d + 1).at[0].set(0.0),
        maxiter=50, ftol=1e-14, pgtol=1e-8)
    assert bool(jnp.all(res.converged))
    assert int(jnp.max(res.num_iterations)) <= 15  # quadratic convergence


def test_densify_bucket():
    indices = jnp.asarray([[[0, 2, 0, 0]], [[1, 1, 0, 0]]], jnp.int32)  # [2,1,4]
    values = jnp.asarray([[[1.0, 2.0, 0.0, 0.0]], [[3.0, 4.0, 0.0, 0.0]]])
    X = densify_bucket(indices, values, 4, has_intercept=True)
    assert X.shape == (2, 1, 5)
    np.testing.assert_allclose(np.asarray(X[0, 0]), [1.0, 1.0, 0.0, 2.0, 0.0])
    # duplicate indices accumulate (COO semantics)
    np.testing.assert_allclose(np.asarray(X[1, 0]), [1.0, 0.0, 7.0, 0.0, 0.0])


def test_padded_lanes_converge_instantly():
    """All-zero (padding) entities must not burn iterations."""
    B, n, d = 4, 8, 3
    X1 = np.zeros((B, n, d + 1))
    res = newton_lr_batch(
        jnp.zeros((B, d + 1)), jnp.asarray(X1), jnp.zeros((B, n)),
        jnp.zeros((B, n)), jnp.zeros((B, n)), jnp.zeros((B,)),
        l2_reg_weight=1.0, l2_mask=jnp.ones(d + 1),
        maxiter=50)
    assert bool(jnp.all(res.converged))
    assert int(jnp.max(res.num_iterations)) == 0


# ------------------------------------------------------ dual (sample-space) --

def _wide_problems(B=10, n=8, d=20, seed=3):
    """samples-per-entity < dim: the regime the dual solver targets."""
    return _problems(B, n, d, seed)


@pytest.mark.parametrize("lam,reg_bias", [(0.5, False), (0.0, False),
                                          (1.0, True)])
def test_dual_newton_matches_scipy(lam, reg_bias):
    B, n, d = 10, 8, 20
    X, y, offsets, weights = _wide_problems(B, n, d)
    ones = np.ones((B, n, 1))
    X1 = np.concatenate([ones, X], axis=2)
    l2_mask = np.ones(d + 1)
    if not reg_bias:
        l2_mask[0] = 0.0
    res = newton_lr_batch(
        jnp.zeros((B, d + 1)), jnp.asarray(X1), jnp.asarray(y),
        jnp.asarray(weights), jnp.asarray(offsets),
        jnp.full((B,), n, jnp.float64),
        l2_reg_weight=lam, l2_mask=jnp.asarray(l2_mask),
        maxiter=60, ftol=1e-14, pgtol=1e-10, dual=True)
    assert bool(jnp.all(res.converged))

    def _loss(t, b):
        z = X1[b] @ t + offsets[b]
        ce = np.maximum(z, 0) - z * y[b] + np.log1p(np.exp(-np.abs(z)))
        reg = t @ t if reg_bias else t[1:] @ t[1:]
        return (np.sum(weights[b] * ce) + 0.5 * lam * reg) / n

    for b in range(B):
        oracle = _scipy_opt(X1[b], y[b], offsets[b], weights[b], lam, reg_bias)
        if lam == 0.0:
            # n < dim and no ridge: the minimizer is non-unique (the loss only
            # sees Xθ, rank ≤ n < dim) — compare objective values instead
            got = _loss(np.asarray(res.theta[b]), b)
            np.testing.assert_allclose(got, _loss(oracle, b), atol=1e-7,
                                       err_msg=f"lane {b}")
        else:
            np.testing.assert_allclose(np.asarray(res.theta[b]), oracle,
                                       atol=3e-5, err_msg=f"lane {b}")


def test_dual_newton_fast_iteration_count():
    B, n, d = 8, 10, 24
    X, y, offsets, weights = _problems(B, n, d, seed=5)
    ones = np.ones((B, n, 1))
    X1 = np.concatenate([ones, X], axis=2)
    res = newton_lr_batch(
        jnp.zeros((B, d + 1)), jnp.asarray(X1), jnp.asarray(y),
        jnp.asarray(weights), jnp.asarray(offsets),
        jnp.full((B,), n, jnp.float64),
        l2_reg_weight=1.0, l2_mask=jnp.ones(d + 1).at[0].set(0.0),
        maxiter=50, ftol=1e-14, pgtol=1e-8, dual=True)
    assert bool(jnp.all(res.converged))
    assert int(jnp.max(res.num_iterations)) <= 15


def test_dual_padded_lanes_converge_instantly():
    B, n, d = 4, 3, 6
    X1 = np.zeros((B, n, d + 1))
    res = newton_lr_batch(
        jnp.zeros((B, d + 1)), jnp.asarray(X1), jnp.zeros((B, n)),
        jnp.zeros((B, n)), jnp.zeros((B, n)), jnp.zeros((B,)),
        l2_reg_weight=1.0, l2_mask=jnp.ones(d + 1),
        maxiter=50, dual=True)
    assert bool(jnp.all(res.converged))
    assert int(jnp.max(res.num_iterations)) == 0


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("reg_bias", [False, True])
def test_dual_variance_matches_explicit_hessian(full, reg_bias):
    """diag(H⁻¹) / 1/diag(H) from the sample-space formulas == the explicit
    un-normalized Hessian (reference binary_logistic_regression.py:144-189)."""
    from gdmix_tpu.ops.newton import dual_variance
    B, n, d, lam, eps = 6, 7, 15, 0.7, 1e-9
    X, y, offsets, weights = _problems(B, n, d, seed=7)
    ones = np.ones((B, n, 1))
    X1 = np.concatenate([ones, X], axis=2)
    rng = np.random.RandomState(11)
    theta = 0.3 * rng.randn(B, d + 1)
    l2_mask = np.ones(d + 1)
    if not reg_bias:
        l2_mask[0] = 0.0
    got = np.asarray(dual_variance(
        jnp.asarray(theta), jnp.asarray(X1), jnp.asarray(y),
        jnp.asarray(weights), jnp.asarray(offsets),
        l2_reg_weight=lam, l2_mask=jnp.asarray(l2_mask), full=full,
        epsilon=eps))
    for b in range(B):
        z = X1[b] @ theta[b] + offsets[b]
        p = expit(z)
        dvec = weights[b] * p * (1 - p)
        H = X1[b].T @ (dvec[:, None] * X1[b]) + lam * np.diag(l2_mask)
        if full:
            expect = np.diag(np.linalg.inv(H + eps * np.eye(d + 1)))
        else:
            expect = 1.0 / (np.diag(H) + eps)
        np.testing.assert_allclose(got[b], expect, rtol=1e-6,
                                   err_msg=f"lane {b} full={full}")


# ------------------------------------------- batch-major shapes vs scipy ----

def _lane_problems(B, n, dim, seed=0, ragged=True):
    """Intercept column first, ragged per-lane counts (rows past the count
    carry weight 0), both classes in every lane's real rows."""
    rng = np.random.RandomState(seed)
    X = np.concatenate([np.ones((B, n, 1)), 0.8 * rng.randn(B, n, dim - 1)],
                       axis=-1)
    counts = rng.randint(2, n + 1, B) if ragged else np.full(B, n)
    w = (np.arange(n)[None, :] < counts[:, None]) \
        * rng.uniform(0.5, 2.0, (B, n))
    off = 0.3 * rng.randn(B, n)
    z = np.einsum("bnd,bd->bn", X, rng.randn(B, dim)) + off
    y = (rng.uniform(size=(B, n)) < expit(z)).astype(np.float64)
    y[:, 0], y[:, 1] = 1.0, 0.0
    return X, y, w, off, counts.astype(np.float64)


def _scipy_lane(X, y, w, off, count, lam, unreg):
    mask = np.ones(X.shape[1])
    if unreg:
        mask[0] = 0.0

    def fg(t):
        z = X @ t + off
        bce = np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))
        return ((np.sum(w * bce) + 0.5 * lam * np.sum(mask * t * t)) / count,
                (X.T @ (w * (expit(z) - y)) + lam * mask * t) / count)

    return fmin_l_bfgs_b(fg, np.zeros(X.shape[1]), m=10, factr=10.0,
                         pgtol=1e-11, maxiter=1000)[0]


def _solve_lanes(X, y, w, off, counts, lam, unreg):
    B, _, dim = X.shape
    mask = np.ones(dim)
    if unreg:
        mask[0] = 0.0
    return newton_lr_batch(
        jnp.zeros((B, dim)), jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        jnp.asarray(off), jnp.asarray(counts), l2_reg_weight=lam,
        l2_mask=jnp.asarray(mask), maxiter=100, ftol=1e-15, pgtol=1e-10)


def _assert_matches_scipy(res, X, y, w, off, counts, lam, unreg, atol=2e-5):
    assert bool(jnp.all(res.converged))
    theta = np.asarray(res.theta)
    for b in range(X.shape[0]):
        n_b = int(counts[b])
        want = _scipy_lane(X[b, :n_b], y[b, :n_b], w[b, :n_b], off[b, :n_b],
                           counts[b], lam, unreg)
        np.testing.assert_allclose(theta[b], want, atol=atol,
                                   err_msg=f"lane {b}")


@pytest.mark.parametrize("B,n,dim,unreg", [(12, 8, 5, True),
                                           (130, 16, 25, True),
                                           (64, 8, 25, False),
                                           (48, 32, 40, True)])
def test_batch_major_shapes_match_scipy(B, n, dim, unreg):
    """Bucket shapes of the production tiers: B past a 128 multiple, dim up
    to 40, regularized and unregularized intercepts."""
    X, y, w, off, counts = _lane_problems(B, n, dim, seed=B)
    res = _solve_lanes(X, y, w, off, counts, 0.7, unreg)
    _assert_matches_scipy(res, X, y, w, off, counts, 0.7, unreg)


def test_long_lanes_match_scipy():
    """n = 512 samples per lane (the heavy tail's big tiers)."""
    X, y, w, off, counts = _lane_problems(16, 512, 9, seed=5)
    res = _solve_lanes(X, y, w, off, counts, 1.0, True)
    _assert_matches_scipy(res, X, y, w, off, counts, 1.0, True)


def test_padding_lanes_leave_real_lanes_unchanged():
    """Zero-count padding lanes appended to a bucket converge at iteration 0
    and the real lanes' solutions equal the unpadded bucket's."""
    X, y, w, off, counts = _lane_problems(7, 8, 5, seed=9)
    pad = 123
    Xp = np.concatenate([X, np.zeros((pad,) + X.shape[1:])])
    yp, wp, offp = (np.concatenate([a, np.zeros((pad, 8))])
                    for a in (y, w, off))
    cp = np.concatenate([counts, np.zeros(pad)])
    full = _solve_lanes(Xp, yp, wp, offp, cp, 0.5, True)
    sub = _solve_lanes(X, y, w, off, counts, 0.5, True)
    assert int(jnp.max(full.num_iterations[7:])) == 0
    np.testing.assert_allclose(np.asarray(full.theta[:7]),
                               np.asarray(sub.theta), atol=1e-12)
    _assert_matches_scipy(sub, X, y, w, off, counts, 0.5, True)


def test_sparse_bucket_layout_matches_scipy():
    """densify_bucket -> newton_lr_batch on the production COO bucket layout
    (local feature ids, value-0 padding entries)."""
    rng = np.random.RandomState(11)
    B, n, k, u_cap = 20, 8, 3, 6
    indices = rng.randint(0, u_cap, (B, n, k)).astype(np.int32)
    values = rng.randn(B, n, k) * (rng.rand(B, n, k) < 0.8)
    X = np.asarray(densify_bucket(jnp.asarray(indices), jnp.asarray(values),
                                  u_cap, True))
    y = (rng.uniform(size=(B, n)) < 0.5).astype(np.float64)
    y[:, 0], y[:, 1] = 1.0, 0.0
    w, off, counts = np.ones((B, n)), np.zeros((B, n)), np.full(B, float(n))
    res = _solve_lanes(X, y, w, off, counts, 1.0, True)
    _assert_matches_scipy(res, X, y, w, off, counts, 1.0, True)


# -------------------------------------------------- damped Cholesky solve ----

def _spd(B, d, seed):
    rng = np.random.RandomState(seed)
    Q = rng.randn(B, d, d)
    return np.einsum("bij,bkj->bik", Q, Q) / d + np.eye(d)[None]


def _damped(H, eps):
    d = H.shape[-1]
    diag = np.abs(np.diagonal(H, axis1=1, axis2=2))
    return H + eps * (1.0 + diag)[:, :, None] * np.eye(d)[None]


@pytest.mark.parametrize("B,d", [(4, 8), (130, 13), (256, 29)])
def test_damped_cholesky_solve_matches_numpy(B, d):
    from gdmix_tpu.ops.newton import damped_cholesky_solve
    H = _spd(B, d, 0)
    g = np.random.RandomState(1).randn(B, d)
    x = damped_cholesky_solve(jnp.asarray(H), jnp.asarray(g), 1e-10)
    want = np.linalg.solve(_damped(H, 1e-10), g[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-8, atol=1e-8)


def test_damped_cholesky_solve_identity_rows():
    """Identity systems (the padding-lane pattern) solve to g/(1 + 2ε)."""
    from gdmix_tpu.ops.newton import damped_cholesky_solve
    B, d, eps = 8, 5, 1e-10
    H = np.broadcast_to(np.eye(d), (B, d, d)).copy()
    g = np.arange(B * d, dtype=np.float64).reshape(B, d)
    x = damped_cholesky_solve(jnp.asarray(H), jnp.asarray(g), eps)
    np.testing.assert_allclose(np.asarray(x), g / (1 + 2 * eps), atol=1e-12)


@pytest.mark.parametrize("B,d,r", [(4, 8, 2), (130, 13, 3), (200, 29, 2)])
def test_damped_cholesky_solve_multiple_rhs(B, d, r):
    from gdmix_tpu.ops.newton import damped_cholesky_solve
    H = _spd(B, d, 2)
    g = np.random.RandomState(3).randn(B, d, r)
    x = damped_cholesky_solve(jnp.asarray(H), jnp.asarray(g), 1e-10)
    want = np.linalg.solve(_damped(H, 1e-10), g)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-8, atol=1e-8)
