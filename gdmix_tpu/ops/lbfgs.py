"""On-device L-BFGS: jittable, vmappable, with scipy-compatible stopping.

This replaces scipy.optimize.fmin_l_bfgs_b, which the reference uses for BOTH the
distributed fixed-effect solve (one large problem; scipy calls back into a TF session
per iteration — /root/reference/gdmix-trainer/src/gdmix/models/custom/
fixed_effect_lr_lbfgs_model.py:635-643) and the per-entity random-effect solves
(/root/reference/gdmix-trainer/src/gdmix/models/custom/binary_logistic_regression.py:
223-231). Here the whole optimization loop lives on device:

  * the objective is a pure JAX function (for the fixed effect it closes over a
    psum along the data mesh axis, so every chip steps in lockstep — the SPMD
    equivalent of the reference's "identical scipy runs on every worker")
  * `vmap(lambda p: lbfgs(...))` yields thousands of independent solves per chip
    (the random-effect batched solver); converged lanes are frozen via masking so
    early finishers take zero-length steps while stragglers continue

Algorithm: standard two-loop recursion with history `m`, gamma-scaled initial
Hessian, and a strong-Wolfe line search (bracket + zoom with quadratic
interpolation and bisection safeguard, Nocedal & Wright alg. 3.5/3.6).

Stopping mirrors fmin_l_bfgs_b: ‖g‖∞ ≤ pgtol, or
(f_k − f_{k+1}) ≤ ftol·max(|f_k|,|f_{k+1}|,1) where ftol = factr·eps — the reference
passes factr = lbfgs_tolerance/eps so ftol equals `lbfgs_tolerance` directly.

Every inner product pins precision=HIGHEST: the curvature pairs and the
line-search slopes must stay float32-accurate on backends whose default
float32 product mode is reduced (TF32 on NVIDIA tensor cores).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

_C1 = 1e-4   # sufficient-decrease (Armijo)
_C2 = 0.9    # curvature
_vdot = partial(jnp.vdot, precision=jax.lax.Precision.HIGHEST)


class LBFGSResult(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    num_iterations: jnp.ndarray
    num_funcalls: jnp.ndarray
    converged: jnp.ndarray        # stopped by ftol/pgtol (not maxiter)
    line_search_failed: jnp.ndarray


class _LSState(NamedTuple):
    done: jnp.ndarray
    failed: jnp.ndarray
    step: jnp.ndarray        # current trial step
    lo: jnp.ndarray          # bracket low endpoint (best so far)
    f_lo: jnp.ndarray
    g_lo: jnp.ndarray        # dphi at lo
    hi: jnp.ndarray          # bracket high endpoint
    f_hi: jnp.ndarray
    bracketed: jnp.ndarray
    best: jnp.ndarray        # accepted step
    f_best: jnp.ndarray
    grad_best: jnp.ndarray   # full gradient at accepted point
    i: jnp.ndarray
    nfev: jnp.ndarray


def _strong_wolfe(fun, x, f0, g0, d, gd0, max_steps: int, dtype):
    """Strong-Wolfe line search along d from x. Returns (alpha, f, g, nfev, failed).

    One fused while_loop implements both the bracketing and zoom phases.
    `fun` returns (value, grad).
    """
    one = jnp.asarray(1.0, dtype)
    zero = jnp.asarray(0.0, dtype)

    def phi(alpha):
        f, g = fun(x + alpha * d)
        return f, g, _vdot(g, d).real.astype(dtype)

    init = _LSState(
        done=jnp.asarray(False),
        failed=jnp.asarray(False),
        step=one,
        lo=zero, f_lo=f0, g_lo=gd0,
        hi=zero, f_hi=f0,
        bracketed=jnp.asarray(False),
        best=zero, f_best=f0, grad_best=g0,
        i=jnp.asarray(0, jnp.int32),
        nfev=jnp.asarray(0, jnp.int32),
    )

    def cond(s: _LSState):
        return jnp.logical_and(~s.done, s.i < max_steps)

    def body(s: _LSState):
        a = s.step
        f_a, grad_a, g_a = phi(a)
        nfev = s.nfev + 1

        armijo_fail = f_a > f0 + _C1 * a * gd0
        not_lower = jnp.logical_and(s.i > 0, f_a >= s.f_lo)
        wolfe_ok = jnp.abs(g_a) <= -_C2 * gd0
        pos_slope = g_a >= 0

        # Case 1: accept — strong Wolfe satisfied.
        accept = jnp.logical_and(~armijo_fail, wolfe_ok)

        in_zoom = s.bracketed
        # --- Bracketing phase transitions (when not yet bracketed) -----------
        # enter zoom with (lo, hi):
        brkt_enter_hi_a = jnp.logical_and(~in_zoom, jnp.logical_or(armijo_fail, not_lower))
        #   zoom(lo=prev_lo, hi=a)
        brkt_enter_lo_a = jnp.logical_and(
            ~in_zoom, jnp.logical_and(~brkt_enter_hi_a, jnp.logical_and(~accept, pos_slope)))
        #   zoom(lo=a, hi=prev_lo)
        extend = jnp.logical_and(
            ~in_zoom, jnp.logical_and(~brkt_enter_hi_a,
                                      jnp.logical_and(~brkt_enter_lo_a, ~accept)))

        # --- Zoom phase transitions (when bracketed) -------------------------
        zoom_shrink_hi = jnp.logical_and(in_zoom, jnp.logical_or(armijo_fail, f_a >= s.f_lo))
        #   hi := a
        zoom_flip = jnp.logical_and(
            in_zoom, jnp.logical_and(~zoom_shrink_hi, jnp.logical_and(
                ~accept, g_a * (s.hi - s.lo) >= 0)))
        #   hi := lo, lo := a
        zoom_advance = jnp.logical_and(in_zoom, jnp.logical_and(~zoom_shrink_hi, ~accept))
        #   lo := a  (zoom_flip additionally moves hi)

        new_bracketed = jnp.logical_or(in_zoom, jnp.logical_or(brkt_enter_hi_a,
                                                               brkt_enter_lo_a))

        # `lo` also tracks the PREVIOUS trial point during bracketing (extend case).
        lo_moves = brkt_enter_lo_a | zoom_advance | extend
        lo = jnp.where(lo_moves, a, s.lo)
        f_lo = jnp.where(lo_moves, f_a, s.f_lo)
        g_lo = jnp.where(lo_moves, g_a, s.g_lo)
        hi = jnp.where(brkt_enter_hi_a | zoom_shrink_hi, a,
                       jnp.where(brkt_enter_lo_a, s.lo, jnp.where(zoom_flip, s.lo, s.hi)))
        f_hi = jnp.where(brkt_enter_hi_a | zoom_shrink_hi, f_a,
                         jnp.where(brkt_enter_lo_a, s.f_lo,
                                   jnp.where(zoom_flip, s.f_lo, s.f_hi)))

        # --- Next trial step --------------------------------------------------
        # Zoom: quadratic interpolation using (lo, f_lo, g_lo) and (hi, f_hi),
        # safeguarded to the middle 80% of the bracket, else bisection.
        denom = 2.0 * (f_hi - f_lo - g_lo * (hi - lo))
        quad = lo - g_lo * (hi - lo) ** 2 / jnp.where(denom == 0, 1.0, denom)
        mid = 0.5 * (lo + hi)
        lo_hi_min = jnp.minimum(lo, hi)
        lo_hi_max = jnp.maximum(lo, hi)
        margin = 0.1 * (lo_hi_max - lo_hi_min)
        quad_ok = jnp.logical_and(denom != 0,
                                  jnp.logical_and(quad > lo_hi_min + margin,
                                                  quad < lo_hi_max - margin))
        zoom_step = jnp.where(quad_ok, quad, mid)
        next_step = jnp.where(new_bracketed, zoom_step, jnp.minimum(2.0 * a, 1e10))

        # Bracket too small → give up (accept lo).
        tiny = (lo_hi_max - lo_hi_min) <= 1e-14 * jnp.maximum(lo_hi_max, 1.0)
        give_up = jnp.logical_and(new_bracketed, tiny)

        done = jnp.logical_or(accept, give_up)
        # If we run out of iterations, the caller falls back to `best`.
        best = jnp.where(accept, a, jnp.where(f_a < s.f_best, a, s.best))
        f_best = jnp.where(accept, f_a, jnp.where(f_a < s.f_best, f_a, s.f_best))
        grad_best = jnp.where(accept | (f_a < s.f_best), grad_a, s.grad_best)

        return _LSState(done=done, failed=jnp.asarray(False),
                        step=next_step, lo=lo, f_lo=f_lo, g_lo=g_lo,
                        hi=hi, f_hi=f_hi, bracketed=new_bracketed,
                        best=best, f_best=f_best, grad_best=grad_best,
                        i=s.i + 1, nfev=nfev)

    s = jax.lax.while_loop(cond, body, init)
    # Failure: nothing decreased f.
    failed = jnp.logical_or(s.best == 0.0, s.f_best > f0)
    alpha = jnp.where(failed, jnp.asarray(0.0, dtype), s.best)
    f_new = jnp.where(failed, f0, s.f_best)
    g_new = jnp.where(failed, g0, s.grad_best)
    return alpha, f_new, g_new, s.nfev, failed


class _State(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    S: jnp.ndarray        # [m, d] s_k = x_{k+1} - x_k (ring buffer)
    Y: jnp.ndarray        # [m, d] y_k = g_{k+1} - g_k
    rho: jnp.ndarray      # [m] 1/(s·y); 0 marks an empty slot
    gamma: jnp.ndarray    # H0 scaling
    k: jnp.ndarray
    nfev: jnp.ndarray
    converged: jnp.ndarray
    ls_failed: jnp.ndarray


def _two_loop(g, S, Y, rho, gamma):
    """Two-loop recursion: r ≈ H·g. Empty slots have rho == 0 and contribute nothing."""
    m = rho.shape[0]

    def first(i, carry):
        q, alphas = carry
        idx = m - 1 - i  # newest → oldest
        alpha = rho[idx] * _vdot(S[idx], q)
        q = q - alpha * Y[idx]
        return q, alphas.at[idx].set(alpha)

    q, alphas = jax.lax.fori_loop(0, m, first, (g, jnp.zeros_like(rho)))
    r = gamma * q

    def second(i, r):
        beta = rho[i] * _vdot(Y[i], r)
        return r + S[i] * (alphas[i] - beta)

    return jax.lax.fori_loop(0, m, second, r)


def lbfgs(fun: Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]],
          x0: jnp.ndarray,
          *,
          m: int = 10,
          ftol: float = 1e-12,
          pgtol: float = 1e-5,
          maxiter: int = 100,
          maxls: int = 25) -> LBFGSResult:
    """Minimize fun (returning (value, grad)) from x0.

    ftol is the relative-f stopping tolerance — the reference's `lbfgs_tolerance`
    (factr·eps in scipy terms). pgtol matches fmin_l_bfgs_b's default 1e-5.
    """
    dtype = x0.dtype
    d = x0.shape[0]
    f0, g0 = fun(x0)
    ftol = jnp.asarray(ftol, dtype)
    pgtol = jnp.asarray(pgtol, dtype)

    init = _State(
        x=x0, f=f0, g=g0,
        S=jnp.zeros((m, d), dtype), Y=jnp.zeros((m, d), dtype),
        rho=jnp.zeros((m,), dtype), gamma=jnp.asarray(1.0, dtype),
        k=jnp.asarray(0, jnp.int32), nfev=jnp.asarray(1, jnp.int32),
        converged=jnp.max(jnp.abs(g0)) <= pgtol,
        ls_failed=jnp.asarray(False),
    )

    def cond(s: _State):
        return jnp.logical_and(s.k < maxiter,
                               jnp.logical_and(~s.converged, ~s.ls_failed))

    def body(s: _State):
        direction = -_two_loop(s.g, s.S, s.Y, s.rho, s.gamma)
        gd = _vdot(s.g, direction)
        # If not a descent direction (numerical breakdown), restart with -g.
        bad = gd >= 0
        direction = jnp.where(bad, -s.g, direction)
        gd = jnp.where(bad, -_vdot(s.g, s.g), gd)

        alpha, f_new, g_new, ls_nfev, ls_failed = _strong_wolfe(
            fun, s.x, s.f, s.g, direction, gd, maxls, dtype)

        x_new = s.x + alpha * direction
        s_vec = x_new - s.x
        y_vec = g_new - s.g
        sy = _vdot(s_vec, y_vec)
        good_pair = sy > 1e-10 * _vdot(y_vec, y_vec)
        # Ring-buffer shift: drop oldest, append newest (masked if pair is bad).
        S = jnp.where(good_pair, jnp.concatenate([s.S[1:], s_vec[None]], axis=0), s.S)
        Y = jnp.where(good_pair, jnp.concatenate([s.Y[1:], y_vec[None]], axis=0), s.Y)
        rho = jnp.where(good_pair,
                        jnp.concatenate([s.rho[1:],
                                         (1.0 / jnp.where(sy == 0, 1.0, sy))[None]]),
                        s.rho)
        gamma = jnp.where(good_pair,
                          sy / jnp.maximum(_vdot(y_vec, y_vec), 1e-30), s.gamma)

        f_drop = s.f - f_new
        rel = jnp.maximum(jnp.maximum(jnp.abs(s.f), jnp.abs(f_new)), 1.0)
        converged = jnp.logical_or(f_drop <= ftol * rel,
                                   jnp.max(jnp.abs(g_new)) <= pgtol)

        return _State(x=x_new, f=f_new, g=g_new, S=S, Y=Y, rho=rho, gamma=gamma,
                      k=s.k + 1, nfev=s.nfev + ls_nfev,
                      converged=converged, ls_failed=ls_failed)

    s = jax.lax.while_loop(cond, body, init)
    return LBFGSResult(x=s.x, f=s.f, g=s.g, num_iterations=s.k, num_funcalls=s.nfev,
                       converged=s.converged, line_search_failed=s.ls_failed)


def lbfgs_batched(fun_batched, X0: jnp.ndarray, *, m: int = 10, ftol: float = 1e-12,
                  pgtol: float = 1e-5, maxiter: int = 100, maxls: int = 25,
                  extra_args=None) -> LBFGSResult:
    """vmap of `lbfgs` over a leading batch axis.

    fun_batched(x, *extra) must map a SINGLE problem's x (plus per-problem extras)
    to (value, grad); extra_args is a pytree whose leaves carry a leading batch axis
    (the per-problem data). Converged lanes are frozen by vmap's while_loop masking
    plus zero-length steps, so padding lanes cost nothing but lockstep time.
    """
    if extra_args is None:
        solver = partial(lbfgs, fun_batched, m=m, ftol=ftol, pgtol=pgtol,
                         maxiter=maxiter, maxls=maxls)
        return jax.vmap(solver)(X0)

    def solve_one(x0, extra):
        return lbfgs(lambda x: fun_batched(x, extra), x0, m=m, ftol=ftol,
                     pgtol=pgtol, maxiter=maxiter, maxls=maxls)

    return jax.vmap(solve_one)(X0, extra_args)
