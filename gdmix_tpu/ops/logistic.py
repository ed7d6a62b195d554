"""Logistic/linear regression objectives on padded-sparse batches.

All functions are pure, jittable, vmappable and dtype-parametric. The math matches
the reference exactly:

  * numerically stable weighted BCE:  max(z,0) − z·y + log1p(exp(−|z|))
    (/root/reference/gdmix-trainer/src/gdmix/models/custom/binary_logistic_regression.py:84-110)
  * fixed-effect objective = SUM of weighted losses + λ·½‖w‖² (bias excluded iff
    has_intercept and not regularize_bias); the λ-term is divided by num_workers
    before the all-reduce (fixed_effect_lr_lbfgs_model.py:353-381)
  * per-entity objective = MEAN: (Σᵢ wᵢ·bceᵢ + λ/2·θᵀθ)/n (binary_logistic_regression.py:102-110)
  * linear regression uses squared difference (y−z)², not halved
    (fixed_effect_lr_lbfgs_model.py:357-358)

Sparse features are padded COO per example: (indices[N,K] int32, values[N,K]) where
padding has value 0.0 (index content is then irrelevant for both X·θ and Xᵀr).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class SparseBatch(NamedTuple):
    """A batch of examples with one sparse feature bag, padded to K nnz/example."""
    indices: jnp.ndarray   # [N, K] int32, global feature ids (padding: any id)
    values: jnp.ndarray    # [N, K] float, padding must be 0.0
    offsets: jnp.ndarray   # [N] float
    labels: jnp.ndarray    # [N] float (0/1 for LR, real for linear regression)
    weights: jnp.ndarray   # [N] float, padding rows must be 0.0 (masks them out)


def pad_rows(tree, multiple: int):
    """Zero-pad dim 0 of every leaf to a multiple of `multiple` (zero values
    and weights keep padding rows out of every data term)."""
    leaves = jax.tree_util.tree_leaves(tree)
    n = leaves[0].shape[0]
    n_pad = -(-max(n, 1) // multiple) * multiple
    if n_pad == n:
        return tree
    return jax.tree_util.tree_map(
        lambda a: jnp.concatenate(
            [a, jnp.zeros((n_pad - n,) + a.shape[1:], a.dtype)]), tree)


def sparse_matvec(theta_w: jnp.ndarray, indices: jnp.ndarray,
                  values: jnp.ndarray) -> jnp.ndarray:
    """X·w for padded-COO X: [N] = Σ_k values[n,k] * w[indices[n,k]]."""
    gathered = jnp.take(theta_w, indices, axis=0)       # [N, K]
    return jnp.sum(gathered * values, axis=-1)


def sparse_rmatvec(indices: jnp.ndarray, values: jnp.ndarray,
                   residual: jnp.ndarray, num_features: int) -> jnp.ndarray:
    """Xᵀ·r for padded-COO X: [D] scatter-add of values[n,k]*r[n] at indices[n,k]."""
    contrib = values * residual[:, None]                # [N, K]
    flat_idx = indices.reshape(-1)
    flat_val = contrib.reshape(-1)
    return jnp.zeros((num_features,), dtype=values.dtype).at[flat_idx].add(flat_val)


class SortedCoo(NamedTuple):
    """Flattened COO entries pre-sorted by feature id (a STATIC permutation):
    Xᵀr becomes a sorted segment-sum instead of a random scatter-add."""
    idx: jnp.ndarray    # [M] int32 feature ids, ascending
    row: jnp.ndarray    # [M] int32 source record ids
    val: jnp.ndarray    # [M] values (padding entries carry 0.0)


def make_sorted_coo(indices: np.ndarray, values: np.ndarray) -> SortedCoo:
    """Host-side one-time sort of padded-COO [N, K] entries by feature id."""
    n, k = indices.shape
    flat_idx = np.asarray(indices).reshape(-1)
    flat_val = np.asarray(values).reshape(-1)
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    order = np.argsort(flat_idx, kind="stable")
    return SortedCoo(idx=jnp.asarray(flat_idx[order].astype(np.int32)),
                     row=jnp.asarray(rows[order]),
                     val=jnp.asarray(flat_val[order]))


def sparse_rmatvec_sorted(coo: SortedCoo, residual: jnp.ndarray,
                          num_features: int) -> jnp.ndarray:
    """Xᵀ·r via sorted segment-sum."""
    contrib = coo.val.astype(residual.dtype) * residual[coo.row]
    return jax.ops.segment_sum(contrib, coo.idx, num_segments=num_features,
                               indices_are_sorted=True)


def stable_bce(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """max(z,0) − z·y + log1p(exp(−|z|)) — the reference's stable form."""
    return (jnp.maximum(logits, 0) - logits * labels
            + jnp.log1p(jnp.exp(-jnp.abs(logits))))


def _l2_mask(d: int, has_intercept: bool, regularize_bias: bool,
             intercept_at_end: bool, dtype) -> jnp.ndarray:
    """1.0 where the L2 penalty applies. The intercept is excluded iff
    has_intercept and not regularize_bias."""
    mask = jnp.ones((d,), dtype=dtype)
    if has_intercept and not regularize_bias:
        pos = d - 1 if intercept_at_end else 0
        mask = mask.at[pos].set(0.0)
    return mask


def l2_value_and_grad(x: jnp.ndarray, l2_reg_weight, *, has_intercept: bool,
                      regularize_bias: bool, intercept_at_end: bool):
    """Standalone λ·½‖x‖² term (used once per solve when the data loss is chunked)."""
    mask = _l2_mask(x.shape[0], has_intercept, regularize_bias, intercept_at_end,
                    x.dtype)
    lam = jnp.asarray(l2_reg_weight, x.dtype)
    return 0.5 * lam * jnp.sum(mask * x * x), lam * mask * x


def fixed_effect_value_and_grad(x: jnp.ndarray,
                                batch: SparseBatch,
                                num_features: int,
                                *,
                                has_intercept: bool = True,
                                regularize_bias: bool = True,
                                l2_reg_weight: float = 1.0,
                                model_type: str = "logistic_regression",
                                num_workers: int = 1,
                                axis_name: Optional[str] = None,
                                sorted_coo: Optional[SortedCoo] = None):
    """Fixed-effect objective: Σ over this shard's samples, then psum over workers.

    x layout: [w(num_features), b] if has_intercept else [w] — matching the reference
    (fixed_effect_lr_lbfgs_model.py:254-258, intercept last).
    Returns (value, grad); both are the all-reduced totals when axis_name is set.
    """
    dtype = x.dtype
    if has_intercept:
        w, b = x[:-1], x[-1]
    else:
        w, b = x, jnp.zeros((), dtype)
    z = sparse_matvec(w, batch.indices, batch.values) + batch.offsets + b

    if model_type == "linear_regression":
        per = (batch.labels - z) ** 2
        dz = 2.0 * (z - batch.labels)
    else:
        per = stable_bce(z, batch.labels)
        dz = jax.nn.sigmoid(z) - batch.labels
    value = jnp.sum(batch.weights * per)
    r = batch.weights * dz
    if sorted_coo is not None:
        grad_w = sparse_rmatvec_sorted(sorted_coo, r, num_features)
    else:
        grad_w = sparse_rmatvec(batch.indices, batch.values, r, num_features)
    if has_intercept:
        grad = jnp.concatenate([grad_w, jnp.sum(r)[None]])
    else:
        grad = grad_w

    # L2 (divided by num_workers so the psum reconstitutes it once).
    mask = _l2_mask(x.shape[0], has_intercept, regularize_bias, True, dtype)
    scale = jnp.asarray(l2_reg_weight / num_workers, dtype)
    value = value + 0.5 * scale * jnp.sum(mask * x * x)
    grad = grad + scale * mask * x

    if axis_name is not None:
        value = jax.lax.psum(value, axis_name)
        grad = jax.lax.psum(grad, axis_name)
    return value, grad


def fixed_effect_value_and_grad_onehot(x: jnp.ndarray,
                                       batch: SparseBatch,
                                       num_features: int,
                                       *,
                                       chunk: int,
                                       has_intercept: bool = True,
                                       model_type: str = "logistic_regression"):
    """Fixed-effect data term via chunked one-hot densification: each chunk's
    padded-COO rows become a dense [chunk, D] block (compare+select), and
    both X·w and Xᵀr run as dense matrix products at precision=HIGHEST (a
    float32 product may otherwise run in TF32 on NVIDIA tensor cores). Exact
    same math as fixed_effect_value_and_grad with l2_reg_weight=0 — the caller
    adds the λ-term once (see FixedEffectLRModel._objective_fun).

    Requires batch length divisible by `chunk` (pad rows carry weight 0).
    """
    dtype = x.dtype
    if has_intercept:
        w, b = x[:-1], x[-1]
    else:
        w, b = x, jnp.zeros((), dtype)
    n = batch.labels.shape[0]
    assert n % chunk == 0, (n, chunk)
    c = n // chunk

    def reshape(a):
        return a.reshape((c, chunk) + a.shape[1:])

    chunks = SparseBatch(*[reshape(a) for a in batch])
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, num_features), 2)
    hi = jax.lax.Precision.HIGHEST

    def body(carry, ch):
        v_acc, g_acc, r_acc = carry
        cb = SparseBatch(*ch)
        Xd = jnp.sum(jnp.where(cb.indices[:, :, None] == iota,
                               cb.values[:, :, None], 0.0), axis=1)
        z = jnp.matmul(Xd, w, precision=hi) + cb.offsets + b
        if model_type == "linear_regression":
            per = (cb.labels - z) ** 2
            dz = 2.0 * (z - cb.labels)
        else:
            per = stable_bce(z, cb.labels)
            dz = jax.nn.sigmoid(z) - cb.labels
        r = cb.weights * dz
        return (v_acc + jnp.sum(cb.weights * per),
                g_acc + jnp.matmul(r, Xd, precision=hi),
                r_acc + jnp.sum(r)), None

    init = (jnp.zeros((), dtype), jnp.zeros((num_features,), dtype),
            jnp.zeros((), dtype))
    (value, grad_w, r_sum), _ = jax.lax.scan(body, init, tuple(chunks))
    grad = (jnp.concatenate([grad_w, r_sum[None]]) if has_intercept else grad_w)
    return value, grad


def fixed_effect_value_and_grad_block(x: jnp.ndarray,
                                      batch: SparseBatch,
                                      num_features: int,
                                      *,
                                      chunk: int,
                                      has_intercept: bool = True,
                                      model_type: str = "logistic_regression",
                                      lane: int = 128,
                                      precision=jax.lax.Precision.HIGHEST):
    """Fixed-effect data term via TWO-LEVEL one-hot decomposition.

    The single-level one-hot path compares every entry against all D feature
    ids (N·K·D elementwise work at large D). Here each id splits as
    idx = hi·lane + lo, and with θ₂ = w reshaped [A, lane] (A = ⌈D/lane⌉):

      gather   θ[idx]  = Σ_l onehot(hi)·θ₂ ⊙ onehot(lo)   (one [e,A]@[A,lane]
                                                           matmul + select)
      scatter  Xᵀr     = (onehot(hi) ⊙ v·r)ᵀ @ onehot(lo)  (one [A,e]@[e,lane]
                                                           matmul)

    One-hot construction drops to N·K·(A + lane) compares — ~D/(A+lane)×
    less elementwise work (≈50× at D=10k) — and the N·K·D multiply-adds run
    as dense matrix products. Works at ANY feature count (the biggest
    intermediate is [chunk·K, A]). `precision` must be float32-accurate
    (HIGHEST, or the exact "bf16x2" split) for solver parity. Same math as
    fixed_effect_value_and_grad with l2_reg_weight=0; the caller adds the
    λ-term once.

    Replaces the reference's whole-epoch TF graph hot loop
    (fixed_effect_lr_lbfgs_model.py:309-392). Requires batch length divisible
    by `chunk` (pad rows carry weight 0).
    """
    dtype = x.dtype
    if has_intercept:
        w, b = x[:-1], x[-1]
    else:
        w, b = x, jnp.zeros((), dtype)
    n, k = batch.indices.shape
    assert n % chunk == 0, (n, chunk)
    c = n // chunk
    e = chunk * k
    a_blocks = max((num_features + lane - 1) // lane, 1)
    d_pad = a_blocks * lane
    theta2 = jnp.zeros((d_pad,), dtype).at[:num_features].set(w) \
        .reshape(a_blocks, lane)
    # precision="bf16x2": exact two-term bf16 splits run as single native
    # bf16 passes (DEFAULT), one-hots are bf16-EXACT (entries 0/1) so the
    # one-hot operand's memory traffic halves vs f32; error ~2^-17 relative
    # (two dots per side), well inside L-BFGS tolerance. Plain DEFAULT would
    # round θ/ce to one bf16 term (2^-8) — too coarse for solver parity.
    split = precision == "bf16x2"
    if split:
        f32 = jnp.float32
        theta_hi = theta2.astype(jnp.bfloat16)
        theta_lo = (theta2.astype(f32) - theta_hi.astype(f32)) \
            .astype(jnp.bfloat16)

    def reshape(arr):
        return arr.reshape((c, chunk) + arr.shape[1:])

    chunks = SparseBatch(*[reshape(arr) for arr in batch])
    iota_a = jax.lax.broadcasted_iota(jnp.int32, (1, a_blocks), 1)
    iota_l = jax.lax.broadcasted_iota(jnp.int32, (1, lane), 1)

    def body(carry, ch):
        v_acc, g2_acc, r_acc = carry
        cb = SparseBatch(*ch)
        idx = cb.indices.reshape(e)
        onehot_dt = jnp.bfloat16 if split else dtype
        hi1 = (idx[:, None] // lane == iota_a).astype(onehot_dt)  # [e, A]
        lo1 = (idx[:, None] % lane == iota_l).astype(onehot_dt)   # [e, lane]
        gdims = (((1,), (0,)), ((), ()))
        if split:
            G = (jax.lax.dot_general(hi1, theta_hi, gdims,
                                     preferred_element_type=f32)
                 + jax.lax.dot_general(hi1, theta_lo, gdims,
                                       preferred_element_type=f32))
            gathered = jnp.sum(G * lo1.astype(f32), axis=1).astype(dtype)
        else:
            G = jax.lax.dot_general(hi1, theta2, gdims,
                                    precision=precision,
                                    preferred_element_type=dtype)  # [e, lane]
            gathered = jnp.sum(G * lo1, axis=1)                # [e] = θ[idx]
        vals = cb.values.reshape(e)
        z = jnp.sum((vals * gathered).reshape(chunk, k), axis=1) \
            + cb.offsets + b
        if model_type == "linear_regression":
            per = (cb.labels - z) ** 2
            dz = 2.0 * (z - cb.labels)
        else:
            per = stable_bce(z, cb.labels)
            dz = jax.nn.sigmoid(z) - cb.labels
        r = cb.weights * dz
        ce = vals * jnp.broadcast_to(r[:, None], (chunk, k)).reshape(e)
        sdims = (((0,), (0,)), ((), ()))
        if split:
            ce32 = ce.astype(f32)
            ce_hi = ce32.astype(jnp.bfloat16)
            ce_lo = (ce32 - ce_hi.astype(f32)).astype(jnp.bfloat16)
            g2 = (jax.lax.dot_general(hi1 * ce_hi[:, None], lo1, sdims,
                                      preferred_element_type=f32)
                  + jax.lax.dot_general(hi1 * ce_lo[:, None], lo1, sdims,
                                        preferred_element_type=f32)
                  ).astype(dtype)
        else:
            g2 = jax.lax.dot_general(hi1 * ce[:, None], lo1, sdims,
                                     precision=precision,
                                     preferred_element_type=dtype)  # [A, lane]
        return (v_acc + jnp.sum(cb.weights * per), g2_acc + g2,
                r_acc + jnp.sum(r)), None

    init = (jnp.zeros((), dtype), jnp.zeros((a_blocks, lane), dtype),
            jnp.zeros((), dtype))
    (value, grad2, r_sum), _ = jax.lax.scan(body, init, tuple(chunks))
    grad_w = grad2.reshape(d_pad)[:num_features]
    grad = (jnp.concatenate([grad_w, r_sum[None]]) if has_intercept else grad_w)
    return value, grad


class HybridAux(NamedTuple):
    """Hot/cold feature split for the wide-D fixed-effect regime.

    Recommender feature spaces are power-law: at D≫1M MOST entries hit a
    small hot set. The D-independent scatter path pays a per-ENTRY random
    gather (forward) and scatter-add (backward). The hybrid remaps the top-A
    frequent features to a compact id space and runs ALL entries through the
    two-level one-hot block path over that compact space (O(A) instead of
    O(D), dense matrix products), while only the cold-tail minority pays the
    per-entry gather/scatter against the full D. The reference's sparse TF
    graph is D-independent too (fixed_effect_lr_lbfgs_model.py:214-392).

    Built ONCE per fit by build_hybrid_aux (the batch is fixed across
    L-BFGS iterations; sweeps reuse it via the device cache)."""
    hot_ids: jnp.ndarray   # [A] int32 global feature id per compact slot
    hot_idx: jnp.ndarray   # [N, K] int32 compact ids; cold/padding → A (dump)
    cold_idx: jnp.ndarray  # [Mc] int32 global ids of cold entries (pad: 0)
    cold_row: jnp.ndarray  # [Mc] int32 source record ids (pad: 0)
    cold_val: jnp.ndarray  # [Mc] values (pad: 0.0 — inert)


@functools.lru_cache(maxsize=None)
def _hybrid_counts_fn(num_features: int):
    @jax.jit
    def f(indices, values):
        m = (values != 0)
        counts = jnp.zeros((num_features,), jnp.int32) \
            .at[indices.reshape(-1)].add(m.reshape(-1).astype(jnp.int32))
        return counts, jnp.sum(m.astype(jnp.int64))
    return f


@functools.lru_cache(maxsize=None)
def _hybrid_hot_fn(hot: int):
    @jax.jit
    def f(counts):
        top_counts, hot_ids = jax.lax.top_k(counts, hot)
        return hot_ids, jnp.cumsum(top_counts.astype(jnp.int64))
    return f


# Cost model for the ADAPTIVE hot-set size (hot_features=0), per entry:
#   hot(A, e)  ≈ e · (HOT_BASE + HOT_PER_FEATURE · A)
#   cold(A, e) ≈ cold_fraction(A) · e · COLD_ENTRY_S
# Only the constants' RATIOS matter (the argmin over A). They are an earlier
# accelerator's calibration, not yet measured on the GPU — the SHAPE of the
# tradeoff (O(A) one-hot build vs per-entry cold walk) is architectural.
HYBRID_HOT_BASE_S = 0.6e-9
HYBRID_HOT_PER_FEATURE_S = 5.8e-14
HYBRID_COLD_ENTRY_S = 35e-9
_HYBRID_A_CANDIDATES = (4096, 8192, 16384, 32768, 65536, 131072)


@functools.lru_cache(maxsize=None)
def _hybrid_build_fn(num_features: int, hot: int, mc_pad: int,
                     shardings=None):
    kw = {}
    if shardings is not None:
        # (replicated, like-indices, batch-1d x3) — keeps the split arrays
        # laid out exactly like the batch they'll be consumed with
        rep, sh2, sh1 = shardings
        kw = dict(out_shardings=HybridAux(rep, sh2, sh1, sh1, sh1))

    @functools.partial(jax.jit, **kw)
    def f(indices, values, hot_ids):
        k = indices.shape[1]
        remap = jnp.full((num_features,), hot, jnp.int32) \
            .at[hot_ids].set(jnp.arange(hot, dtype=jnp.int32))
        idx_c = jnp.take(remap, indices)                       # [N, K]
        m = values != 0
        hot_idx = jnp.where(m & (idx_c < hot), idx_c, hot)
        is_cold = (idx_c == hot) & m
        flat_cold = is_cold.reshape(-1)
        nk = flat_cold.shape[0]
        dest = jnp.cumsum(flat_cold.astype(jnp.int32)) - 1
        tgt = jnp.where(flat_cold, dest, mc_pad)               # drop non-cold
        src = jnp.arange(nk, dtype=jnp.int32)
        pos = jnp.zeros((mc_pad,), jnp.int32).at[tgt].set(src, mode="drop")
        valid = jnp.zeros((mc_pad,), jnp.bool_).at[tgt].set(True, mode="drop")
        cold_idx = jnp.where(valid, indices.reshape(-1)[pos], 0)
        cold_val = jnp.where(valid, values.reshape(-1)[pos], 0.0)
        cold_row = jnp.where(valid, (pos // k).astype(jnp.int32), 0)
        return HybridAux(hot_ids, hot_idx, cold_idx, cold_row, cold_val)
    return f


def build_hybrid_aux(indices, values, num_features: int, *,
                     hot_features: int = 0,
                     cold_max_frac: float = 0.6,
                     pad_multiple: int = 8,
                     shardings=None) -> Optional[HybridAux]:
    """Build the hot/cold split for a CONCRETE batch (host numpy or device
    arrays — all heavy passes run on device; only small replicated scalars
    come to host). Returns None when the data doesn't reward the split
    (cold fraction above `cold_max_frac`, e.g. uniform ids): the caller
    then keeps the plain scatter path — the decision is data-driven, not
    hard-coded.

    hot_features=0 (the default) picks the hot-set size ADAPTIVELY: the
    builder already holds the frequency counts, so it evaluates the
    cost model (HYBRID_* constants) at pow-2 candidate sizes and takes the
    argmin — steeper distributions get smaller hot sets, flatter ones bigger
    (zipf-1.2 at N=5M, K=16, D=1M resolves to 16384).

    Multi-host safe: every pass is a jitted SPMD computation over the
    global arrays; host fetches are of fully-replicated values."""
    adaptive = hot_features <= 0
    cap = min(_HYBRID_A_CANDIDATES[-1] if adaptive else hot_features,
              num_features)
    if cap <= 0:
        return None
    counts, total = _hybrid_counts_fn(num_features)(indices, values)
    hot_ids_full, cum = _hybrid_hot_fn(int(cap))(counts)
    total = int(total)
    if total == 0:
        return None
    if adaptive:
        cands = [c for c in _HYBRID_A_CANDIDATES if c <= cap] or [int(cap)]
        covered = np.asarray(jax.device_get(
            cum[jnp.asarray([c - 1 for c in cands])]), np.int64)
        e = total
        best_a, best_cost = cands[0], float("inf")
        for c, cov in zip(cands, covered):
            cost = (e * (HYBRID_HOT_BASE_S + HYBRID_HOT_PER_FEATURE_S * c)
                    + (e - int(cov)) * HYBRID_COLD_ENTRY_S)
            if cost < best_cost:
                best_a, best_cost = c, cost
        a_eff = int(best_a)
        mc = total - int(covered[cands.index(best_a)])
        hot_ids = hot_ids_full[:a_eff]
    else:
        a_eff = int(cap)
        mc = total - int(jax.device_get(cum[a_eff - 1]))
        hot_ids = hot_ids_full
    if mc / max(total, 1) > cold_max_frac:
        return None
    # capacity tiers bound recompiles across fits; 1/8-mantissa pow2 steps
    # keep the padding ≤12.5% — cold padding entries are inert but still
    # PROCESSED by the per-entry scatter, so a plain pow2 tier could double
    # the cold side's work
    mult = max(int(pad_multiple), 1)
    mc_eff = max(mc, 1)
    step = 1 << max((mc_eff - 1).bit_length() - 3, 0)
    mc_pad = ((mc_eff + step - 1) // step) * step
    mc_pad = ((mc_pad + mult - 1) // mult) * mult
    build = _hybrid_build_fn(num_features, a_eff, mc_pad, shardings)
    return build(indices, values, hot_ids)


def fixed_effect_value_and_grad_hybrid(x: jnp.ndarray,
                                       batch: SparseBatch,
                                       aux: HybridAux,
                                       num_features: int,
                                       *,
                                       chunk: int,
                                       has_intercept: bool = True,
                                       model_type: str = "logistic_regression",
                                       lane: int = 128,
                                       precision=jax.lax.Precision.HIGHEST,
                                       row_map=None):
    """Fixed-effect data term with the hot/cold split (see HybridAux).

    Forward: z = z_hot + z_cold + offset + b, where z_hot rides the compact
    two-level one-hot gather (same matmul construction as
    fixed_effect_value_and_grad_block, dump slot gathers θ=0 so cold entries
    contribute nothing) and z_cold is a per-entry gather+row-scatter over
    the cold minority. Backward mirrors it: the compact [A]-gradient comes
    off the matmul scatter and lands in grad[hot_ids] (A unique indices);
    cold entries scatter-add straight into grad[D]. Exact same math as
    fixed_effect_value_and_grad with l2_reg_weight=0 — the caller adds the
    λ-term once.

    The hot scan is row-local: `row_map(fn, shared, rows)` runs it
    (parallel/mesh.sum_over_rows on a multi-device mesh, each device on its
    own rows); the cold side's gather/scatter-add run over the whole batch.
    Rows are zero-padded to a multiple of `chunk` inside the scan."""
    dtype = x.dtype
    if has_intercept:
        w, b = x[:-1], x[-1]
    else:
        w, b = x, jnp.zeros((), dtype)
    n, k = aux.hot_idx.shape
    a_eff = aux.hot_ids.shape[0]
    a_blocks = (a_eff + 1 + lane - 1) // lane   # +1: the dump slot gathers 0
    a_pad = a_blocks * lane
    w_c = jnp.take(w, aux.hot_ids)               # [A] compact hot coefficients
    theta2 = jnp.zeros((a_pad,), dtype).at[:a_eff].set(w_c) \
        .reshape(a_blocks, lane)
    split = precision == "bf16x2"
    if split:
        f32 = jnp.float32
        theta_hi = theta2.astype(jnp.bfloat16)
        theta_lo = (theta2.astype(f32) - theta_hi.astype(f32)) \
            .astype(jnp.bfloat16)

    # cold forward correction: fold into the offsets the scan consumes
    z_cold = jnp.zeros((n,), dtype).at[aux.cold_row] \
        .add(jnp.take(w, aux.cold_idx) * aux.cold_val.astype(dtype))
    offsets2 = batch.offsets + z_cold

    iota_a = jax.lax.broadcasted_iota(jnp.int32, (1, a_blocks), 1)
    iota_l = jax.lax.broadcasted_iota(jnp.int32, (1, lane), 1)

    def body(carry, ch):
        v_acc, g2_acc = carry
        c_idx, c_val, c_off, c_lab, c_wt = ch
        chunk, k = c_idx.shape
        e = chunk * k
        idx = c_idx.reshape(e)
        onehot_dt = jnp.bfloat16 if split else dtype
        hi1 = (idx[:, None] // lane == iota_a).astype(onehot_dt)  # [e, A/l]
        lo1 = (idx[:, None] % lane == iota_l).astype(onehot_dt)   # [e, lane]
        gdims = (((1,), (0,)), ((), ()))
        if split:
            G = (jax.lax.dot_general(hi1, theta_hi, gdims,
                                     preferred_element_type=f32)
                 + jax.lax.dot_general(hi1, theta_lo, gdims,
                                       preferred_element_type=f32))
            gathered = jnp.sum(G * lo1.astype(f32), axis=1).astype(dtype)
        else:
            G = jax.lax.dot_general(hi1, theta2, gdims, precision=precision,
                                    preferred_element_type=dtype)
            gathered = jnp.sum(G * lo1, axis=1)               # [e] = θc[idx]
        vals = c_val.reshape(e)
        z = jnp.sum((vals * gathered).reshape(chunk, k), axis=1) + c_off + b
        if model_type == "linear_regression":
            per = (c_lab - z) ** 2
            dz = 2.0 * (z - c_lab)
        else:
            per = stable_bce(z, c_lab)
            dz = jax.nn.sigmoid(z) - c_lab
        r = c_wt * dz
        ce = vals * jnp.broadcast_to(r[:, None], (chunk, k)).reshape(e)
        sdims = (((0,), (0,)), ((), ()))
        if split:
            ce32 = ce.astype(f32)
            ce_hi = ce32.astype(jnp.bfloat16)
            ce_lo = (ce32 - ce_hi.astype(f32)).astype(jnp.bfloat16)
            g2 = (jax.lax.dot_general(hi1 * ce_hi[:, None], lo1, sdims,
                                      preferred_element_type=f32)
                  + jax.lax.dot_general(hi1 * ce_lo[:, None], lo1, sdims,
                                        preferred_element_type=f32)
                  ).astype(dtype)
        else:
            g2 = jax.lax.dot_general(hi1 * ce[:, None], lo1, sdims,
                                     precision=precision,
                                     preferred_element_type=dtype)
        return (v_acc + jnp.sum(c_wt * per), g2_acc + g2), r

    def hot_scan(_, rows):
        n_local = rows[0].shape[0]
        ch = min(chunk, n_local)
        chunks = tuple(a.reshape((-1, ch) + a.shape[1:])
                       for a in pad_rows(rows, ch))
        init = (jnp.zeros((), dtype), jnp.zeros((a_blocks, lane), dtype))
        summed, r_chunks = jax.lax.scan(body, init, chunks)
        return summed, r_chunks.reshape(-1)[:n_local]

    rows = (aux.hot_idx, batch.values, offsets2, batch.labels, batch.weights)
    (value, grad2), r_full = (hot_scan((), rows) if row_map is None
                              else row_map(hot_scan, (), rows))
    grad_hot = grad2.reshape(a_pad)[:a_eff]
    grad_w = jnp.zeros((num_features,), dtype) \
        .at[aux.cold_idx].add(aux.cold_val.astype(dtype)
                              * jnp.take(r_full, aux.cold_row)) \
        .at[aux.hot_ids].add(grad_hot)
    grad = (jnp.concatenate([grad_w, jnp.sum(r_full)[None]])
            if has_intercept else grad_w)
    return value, grad


def per_entity_value_and_grad(theta: jnp.ndarray,
                              batch: SparseBatch,
                              num_features: int,
                              *,
                              has_intercept: bool = True,
                              regularize_bias: bool = False,
                              l2_reg_weight: float = 0.0,
                              sample_count: Optional[jnp.ndarray] = None):
    """Per-entity objective (MEAN form, reference binary_logistic_regression.py:84-131).

    theta layout: [b, w(num_features)] if has_intercept else [w] — intercept FIRST,
    matching the reference per-entity solver.

    batch rows beyond the entity's true sample count must have weights == 0;
    sample_count (scalar) is the true n used for the 1/n normalization (defaults to
    the padded row count).
    """
    dtype = theta.dtype
    n = (jnp.asarray(batch.labels.shape[0], dtype) if sample_count is None
         else sample_count.astype(dtype))
    n = jnp.maximum(n, 1.0)
    if has_intercept:
        b, w = theta[0], theta[1:]
    else:
        b, w = jnp.zeros((), dtype), theta
    z = sparse_matvec(w, batch.indices, batch.values) + batch.offsets + b
    per = stable_bce(z, batch.labels)
    dz = jax.nn.sigmoid(z) - batch.labels

    value = jnp.sum(batch.weights * per)
    r = batch.weights * dz
    grad_w = sparse_rmatvec(batch.indices, batch.values, r, num_features)
    if has_intercept:
        grad = jnp.concatenate([jnp.sum(r)[None], grad_w])
    else:
        grad = grad_w

    mask = _l2_mask(theta.shape[0], has_intercept, regularize_bias, False, dtype)
    lam = jnp.asarray(l2_reg_weight, dtype)
    value = (value + 0.5 * lam * jnp.sum(mask * theta * theta)) / n
    grad = (grad + lam * mask * theta) / n
    return value, grad


def predict_logits(theta: jnp.ndarray, batch: SparseBatch, *,
                   has_intercept: bool = True,
                   intercept_at_end: bool = False) -> jnp.ndarray:
    """Logits including offsets for either coefficient layout."""
    dtype = theta.dtype
    if has_intercept:
        if intercept_at_end:
            w, b = theta[:-1], theta[-1]
        else:
            w, b = theta[1:], theta[0]
    else:
        w, b = theta, jnp.zeros((), dtype)
    return sparse_matvec(w, batch.indices, batch.values) + batch.offsets + b


def hessian_diag(theta: jnp.ndarray, batch: SparseBatch, num_features: int, *,
                 has_intercept: bool = True, intercept_at_end: bool = False
                 ) -> jnp.ndarray:
    """diag(XᵀDX) with D = diag(w·ρ(1−ρ)), ρ = σ(logit incl offset).

    λ/ε handling is left to the caller (modes differ between fixed/random effect).
    """
    z = predict_logits(theta, batch, has_intercept=has_intercept,
                       intercept_at_end=intercept_at_end)
    rho = jax.nn.sigmoid(z)
    d = rho * (1 - rho) * batch.weights
    contrib = (batch.values ** 2) * d[:, None]
    diag_w = jnp.zeros((num_features,), dtype=theta.dtype) \
        .at[batch.indices.reshape(-1)].add(contrib.reshape(-1))
    if not has_intercept:
        return diag_w
    diag_b = jnp.sum(d)[None]
    return (jnp.concatenate([diag_w, diag_b]) if intercept_at_end
            else jnp.concatenate([diag_b, diag_w]))


def hessian_full(theta: jnp.ndarray, batch: SparseBatch, num_features: int, *,
                 has_intercept: bool = True, intercept_at_end: bool = False
                 ) -> jnp.ndarray:
    """Full XᵀDX (densified) for FULL-mode variance; fine for small d."""
    z = predict_logits(theta, batch, has_intercept=has_intercept,
                       intercept_at_end=intercept_at_end)
    rho = jax.nn.sigmoid(z)
    d = rho * (1 - rho) * batch.weights
    n = batch.labels.shape[0]
    X = jnp.zeros((n, num_features), dtype=theta.dtype)
    row = jnp.broadcast_to(jnp.arange(n)[:, None], batch.indices.shape)
    X = X.at[row.reshape(-1), batch.indices.reshape(-1)].add(batch.values.reshape(-1))
    if has_intercept:
        ones = jnp.ones((n, 1), dtype=theta.dtype)
        X = (jnp.concatenate([X, ones], axis=1) if intercept_at_end
             else jnp.concatenate([ones, X], axis=1))
    dX = X * d[:, None]
    return jnp.matmul(X.T, dX, precision=jax.lax.Precision.HIGHEST)
