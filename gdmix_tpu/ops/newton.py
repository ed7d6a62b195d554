"""Batched Newton–Cholesky solver for per-entity logistic regression.

The random-effect problems are tiny (entity feature support ≤ a few dozen), so
exact Newton with a batched Cholesky solve converges in ~5–10 iterations where
L-BFGS needs 50–300 sequential steps — and every step here is batched dense
work (einsums over [B, n, d] densified entity matrices) instead of long chains
of small elementwise ops. Same convex optimum as the reference's scipy L-BFGS
(binary_logistic_regression.py:223), verified in tests; the L-BFGS path
(ops/lbfgs.py) remains for large-support problems.

Objective (reference MEAN form): f(θ) = (Σ wᵢ·bce(zᵢ) + λ/2·θᵀMθ)/n with
z = Xθ + offset, M the bias-exclusion mask.

Every contraction pins precision=HIGHEST: a float32 product may otherwise run
in TF32 on NVIDIA tensor cores. Measured on an H100 (80GB HBM3, 700 W) on the
100k-entity d=24 fleet: with TF32 every entity still stops (by the
no-decrease rule), but 2.5× farther from the float64 optimum (max |Δθ|
8.4e-4 against 3.3e-4 over 256 sampled entities), and HIGHEST took no
longer (0.76-0.78 s against 0.79 s for the 305-bucket solve).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_ARMIJO_C1 = 1e-4
_MAX_BACKTRACKS = 20
_HIGHEST = jax.lax.Precision.HIGHEST


def _einsum(spec, *operands):
    return jnp.einsum(spec, *operands, precision=_HIGHEST)


class NewtonResult(NamedTuple):
    theta: jnp.ndarray       # [B, dim]
    converged: jnp.ndarray   # [B]
    num_iterations: jnp.ndarray  # [B]


def _cho_solve_batched(L: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """K⁻¹·rhs from L = chol(K); L [B, n, n], rhs [B, n, r]."""
    y = jax.lax.linalg.triangular_solve(L, rhs, left_side=True, lower=True)
    return jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                           transpose_a=True)


def damped_cholesky_solve(H: jnp.ndarray, g: jnp.ndarray,
                          eps) -> jnp.ndarray:
    """(H + diag(ε·(1 + |diag H|)))⁻¹·g for a batch of SPD systems; H
    [B, d, d], g [B, d] or [B, d, r]. The Levenberg damping keeps padded and
    degenerate lanes (all-zero rows, identity padding) solvable."""
    d = H.shape[-1]
    damp = eps * (1.0 + jnp.abs(jnp.diagonal(H, axis1=1, axis2=2)))
    Hd = H + jnp.zeros_like(H).at[:, jnp.arange(d), jnp.arange(d)].set(damp)
    chol, low = jax.scipy.linalg.cho_factor(Hd)
    return jax.scipy.linalg.cho_solve((chol, low), g)


def newton_lr_batch(theta0: jnp.ndarray,
                    X: jnp.ndarray,
                    labels: jnp.ndarray,
                    weights: jnp.ndarray,
                    offsets: jnp.ndarray,
                    counts: jnp.ndarray,
                    *,
                    l2_reg_weight: float,
                    l2_mask: jnp.ndarray,
                    maxiter: int = 50,
                    ftol: float = 1e-12,
                    pgtol: float = 1e-5,
                    dual: bool = False) -> NewtonResult:
    """Minimize the per-entity LR objective for a whole bucket at once.

    theta0  [B, dim]; X [B, n, dim] (dense, intercept column included by the
    caller); labels/weights/offsets [B, n] (padding rows have weight 0);
    counts [B] true sample counts; l2_mask [dim] (0 on unregularized intercept).

    dual=True computes the Newton step in SAMPLE space (Woodbury): with
    Ũ = √D·X and D = diag(w·p·(1−p)), the primal Hessian λM + XᵀDX is
    inverted through the n×n kernel K = αI_n + ŨŨᵀ instead of a dim×dim
    Cholesky — O(n²·dim) per iteration instead of O(n·dim² + dim³), and no
    [B, dim, dim] Hessian is ever materialized. The fast path for wide-support
    buckets where samples-per-entity < feature dim. Requires l2_mask to be all
    ones except an optional 0 at coordinate 0 (the unregularized-intercept
    layout); the mask's rank-1 hole is folded back in by Sherman–Morrison.
    """
    dtype = theta0.dtype
    B, n, dim = X.shape

    lam = jnp.asarray(l2_reg_weight, dtype)
    mask = l2_mask.astype(dtype)
    inv_n = 1.0 / jnp.maximum(counts.astype(dtype), 1.0)       # [B]
    eps = jnp.asarray(1e-10 if dtype == jnp.float64 else 1e-6, dtype)

    # Everything downstream works from z = Xθ + offset carried in the loop
    # state: the margins are updated INCREMENTALLY (z − step·Xδ) instead of
    # recomputed as X@θ, so the dense [B, n, dim] X — the HBM-dominant
    # operand on wide-support buckets — is read once per line-search, not
    # once per trial, and never for the loss/gradient at the accepted point.
    def _f_from_z(z, theta):
        bce = jnp.maximum(z, 0) - z * labels + jnp.log1p(jnp.exp(-jnp.abs(z)))
        data = jnp.sum(weights * bce, axis=1)
        reg = 0.5 * lam * jnp.sum(mask * theta * theta, axis=1)
        return (data + reg) * inv_n                             # [B]

    def _grad_from_z(z, theta):
        r = weights * (jax.nn.sigmoid(z) - labels)              # [B, n]
        return (_einsum("bnd,bn->bd", X, r) + lam * mask * theta) \
            * inv_n[:, None]

    def hess(p):
        d = weights * p * (1 - p)                               # [B, n]
        H = _einsum("bnd,bn,bne->bde", X, d, X) \
            + lam * jnp.diag(mask)[None]
        return H * inv_n[:, None, None]

    # State carries (g, z) forward so each iteration computes exactly one
    # Hessian, one gradient and ~1 line-search value per lane.
    class _S(NamedTuple):
        theta: jnp.ndarray
        f: jnp.ndarray
        g: jnp.ndarray
        z: jnp.ndarray           # Xθ + offset at theta (margins)
        done: jnp.ndarray
        iters: jnp.ndarray
        k: jnp.ndarray

    def cond(s: _S):
        return jnp.logical_and(s.k < maxiter, ~jnp.all(s.done))

    n_f = jnp.maximum(counts.astype(dtype), 1.0)               # [B]

    def _delta_primal(g, p):
        return damped_cholesky_solve(hess(p), g, eps)

    if dual:
        # The Gram matrix is iteration-invariant: Ũ = √d·X changes with the
        # sigmoid curvature d each Newton step, but ŨŨᵀ = √d√dᵀ ⊙ (XXᵀ) — so
        # the only per-iteration matmuls are O(n·dim) matvecs, and the n×n
        # kernel build is elementwise.
        G = _einsum("bnd,bmd->bnm", X, X)
        eye_n = jnp.eye(n, dtype=dtype)
        X0 = X[:, :, 0]          # intercept column, iteration-invariant

    def _delta_dual(g, p):
        # Solve (λI + XᵀDX − c·e₀e₀ᵀ + μI)·δ = g_un in sample space.
        d = weights * p * (1 - p)                               # [B, n]
        g_un = g * n_f[:, None]                                 # drop the 1/n
        diag_un = lam * mask[None, :] \
            + _einsum("bnd,bn->bd", X * X, d)                    # diag of H_un
        mu = eps * (1.0 + jnp.max(diag_un, axis=1))             # scalar damping
        alpha = lam + mu                                        # [B]
        sd = jnp.sqrt(d)
        K = sd[:, :, None] * sd[:, None, :] * G \
            + alpha[:, None, None] * eye_n[None]
        t = sd * _einsum("bnd,bd->bn", X, g_un)                  # Ũ·g_un
        rhs = jnp.stack([t, sd * X0], axis=-1)                  # [B, n, 2]
        sol = _cho_solve_batched(jnp.linalg.cholesky(K), rhs)
        # A⁻¹v = (v − Ũᵀ K⁻¹ Ũ v)/α  for A = αI + ŨᵀŨ; Ũᵀw = Xᵀ(√d ⊙ w).
        # Both back-substitutions ride ONE batched dot (one X read) instead
        # of two separate matvecs.
        back = _einsum("bnd,bnk->bkd", X, sd[:, :, None] * sol)
        Ag = (g_un - back[:, 0]) / alpha[:, None]
        c = lam * (1.0 - mask[0])                               # intercept hole
        e0 = jnp.zeros((dim,), dtype).at[0].set(1.0)
        Ae0 = (e0[None, :] - back[:, 1]) / alpha[:, None]
        # Sherman–Morrison for −c·e₀e₀ᵀ; denom ≥ μ/α > 0 by construction.
        denom = 1.0 - c * Ae0[:, 0]
        return Ag + c * Ae0 * (Ag[:, 0] / denom)[:, None]

    _delta = _delta_dual if dual else _delta_primal

    def body(s: _S):
        delta = _delta(s.g, jax.nn.sigmoid(s.z))                # [B, dim]
        gdot = jnp.sum(s.g * delta, axis=1)                     # ≥ 0 for PD H
        zdelta = _einsum("bnd,bd->bn", X, delta)                 # one X read

        # Backtracking Armijo: while_loop exits as soon as every live lane
        # accepted (typical case: one evaluation at step 1). Trials are
        # elementwise in the carried margins (z − step·Xδ): no X read here.
        def bt_cond(carry):
            step, accepted, f_new, i = carry
            return jnp.logical_and(i < _MAX_BACKTRACKS,
                                   ~jnp.all(accepted | s.done))

        def bt_body(carry):
            step, accepted, f_new, i = carry
            trial = s.theta - step[:, None] * delta
            f_trial = _f_from_z(s.z - step[:, None] * zdelta, trial)
            ok = f_trial <= s.f - _ARMIJO_C1 * step * gdot
            newly = jnp.logical_and(ok, ~accepted)
            f_new = jnp.where(newly, f_trial, f_new)
            step_keep = jnp.where(accepted | newly, step, step * 0.5)
            return step_keep, accepted | newly, f_new, i + 1

        step0 = jnp.ones((B,), dtype)
        step, accepted, f_new, _ = jax.lax.while_loop(
            bt_cond, bt_body,
            (step0, jnp.zeros((B,), bool), s.f, jnp.asarray(0, jnp.int32)))

        move = jnp.logical_and(accepted, ~s.done)
        theta_new = jnp.where(move[:, None],
                              s.theta - step[:, None] * delta, s.theta)
        z_new = jnp.where(move[:, None], s.z - step[:, None] * zdelta, s.z)
        # the carried margins are updated incrementally (z − step·Xδ) —
        # exact in real arithmetic, but rounding accumulates over many
        # iterations into the f/g/convergence checks; refresh from theta
        # every 16 iterations to bound the drift (one extra X read / 16)
        z_new = jax.lax.cond(
            (s.k + 1) % 16 == 0,
            lambda: _einsum("bnd,bd->bn", X, theta_new) + offsets,
            lambda: z_new)
        f_next = jnp.where(move, f_new, s.f)

        g_new = _grad_from_z(z_new, theta_new)
        gmax = jnp.max(jnp.abs(g_new), axis=1)
        f_drop = s.f - f_next
        rel = jnp.maximum(jnp.maximum(jnp.abs(s.f), jnp.abs(f_next)), 1.0)
        conv = jnp.logical_or(gmax <= pgtol, f_drop <= ftol * rel)
        # a lane that can't backtrack any decrease is finished too
        done = s.done | conv | ~accepted
        iters = jnp.where(s.done, s.iters, s.iters + 1)
        return _S(theta=theta_new, f=f_next, g=g_new, z=z_new, done=done,
                  iters=iters, k=s.k + 1)

    z0 = _einsum("bnd,bd->bn", X, theta0) + offsets
    f0 = _f_from_z(z0, theta0)
    g0 = _grad_from_z(z0, theta0)
    init = _S(theta=theta0, f=f0, g=g0, z=z0,
              done=jnp.max(jnp.abs(g0), axis=1) <= pgtol,
              iters=jnp.zeros((B,), jnp.int32), k=jnp.asarray(0, jnp.int32))
    s = jax.lax.while_loop(cond, body, init)
    return NewtonResult(theta=s.theta, converged=s.done, num_iterations=s.iters)


def dual_variance(theta: jnp.ndarray, X: jnp.ndarray, labels: jnp.ndarray,
                  weights: jnp.ndarray, offsets: jnp.ndarray, *,
                  l2_reg_weight: float, l2_mask: jnp.ndarray,
                  full: bool, epsilon: float = 1e-12) -> jnp.ndarray:
    """Per-entity coefficient variance without materializing [B, dim, dim].

    Same estimator as the primal path (reference
    binary_logistic_regression.py:144-189, un-normalized Hessian H = λM + XᵀDX
    with ε ridge): SIMPLE = 1/diag(H), FULL = diag(H⁻¹) — the FULL inverse
    diagonal computed in sample space: diag(A⁻¹) = (1 − colnorms²(L⁻¹Ũ))/α
    for A = αI + ŨᵀŨ, plus the Sherman–Morrison diag correction for the
    unregularized-intercept hole. l2_mask must be all ones except an optional
    0 at coordinate 0 (same contract as newton_lr_batch(dual=True))."""
    dtype = theta.dtype
    B, n, dim = X.shape
    lam = jnp.asarray(l2_reg_weight, dtype)
    mask = l2_mask.astype(dtype)
    z = _einsum("bnd,bd->bn", X, theta) + offsets
    p = jax.nn.sigmoid(z)
    d = weights * p * (1 - p)                                   # [B, n]
    diag_un = lam * mask[None, :] + _einsum("bnd,bn->bd", X * X, d)
    if not full:
        return 1.0 / (diag_un + epsilon)
    alpha = lam + epsilon
    Xs = X * jnp.sqrt(d)[..., None]                             # Ũ
    K = _einsum("bnd,bmd->bnm", Xs, Xs) \
        + alpha * jnp.eye(n, dtype=dtype)[None]
    L = jnp.linalg.cholesky(K)
    W = jax.lax.linalg.triangular_solve(L, Xs, left_side=True, lower=True)
    diag_A = (1.0 - jnp.sum(W * W, axis=1)) / alpha             # [B, dim]
    c = lam * (1.0 - mask[0])
    yu = _cho_solve_batched(L, Xs[:, :, 0:1])[..., 0]           # K⁻¹·Ũe₀
    e0 = jnp.zeros((dim,), dtype).at[0].set(1.0)
    Ae0 = (e0[None, :] - _einsum("bnd,bn->bd", Xs, yu)) / alpha
    denom = 1.0 - c * Ae0[:, 0]                                 # = ε/(λ+ε) > 0
    return diag_A + c * (Ae0 * Ae0) / denom[:, None]


def densify_bucket(indices: jnp.ndarray, values: jnp.ndarray, u_cap: int,
                   has_intercept: bool) -> jnp.ndarray:
    """Padded-COO bucket [B, n, K] → dense [B, n, dim] with the intercept column
    FIRST (random-effect layout).

    Built as a sum of K comparison one-hots rather than a scatter-add: an
    elementwise compare-select that XLA fuses into one [B, n, dim]
    materialization, with no scatter to serialize or to compile per bucket
    shape; duplicate entry indices accumulate exactly as a scatter-add would."""
    B, n, K = indices.shape
    iota = jax.lax.broadcasted_iota(indices.dtype, (1, 1, 1, u_cap), 3)
    X = jnp.sum(
        jnp.where(indices[..., None] == iota, values[..., None], 0),
        axis=2)                                                 # [B, n, u_cap]
    if has_intercept:
        ones = jnp.ones((B, n, 1), values.dtype)
        X = jnp.concatenate([ones, X], axis=-1)
    return X
