"""Every fixed-effect grad_mode through FixedEffectLRModel._objective_fun (the
wrapper's mode choice, chunk padding and L2 wiring included) against the
float64 gather/scatter reference, plus float32 fits per mode against the
scipy oracle — the float32 path is what the accelerator runs."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import fe_reference
from gdmix_tpu.models.fixed_effect_lr import _PRECISIONS, FixedEffectLRModel
from gdmix_tpu.ops.logistic import SparseBatch
from gdmix_tpu.params import FixedLRParams, Params

MODES = ("scatter", "segment", "onehot", "block", "hybrid")
D, N, K = 300, 1000, 4      # D spans 3 lane blocks; N pads to the chunk
LAM = 0.7


def _model(tmp_path, grad_mode, model_type="logistic_regression", **over):
    md_file = os.path.join(str(tmp_path), "tensor_metadata.json")
    with open(md_file, "w") as f:
        json.dump({"features": [
            {"name": "global", "dtype": "float", "shape": [D],
             "isSparse": True}],
            "labels": [{"name": "response", "dtype": "float", "shape": [],
                        "isSparse": False}]}, f)
    params = dict(metadata_file=md_file, output_model_dir=str(tmp_path),
                  feature_bag="global", l2_reg_weight=LAM,
                  regularize_bias=False, dtype="float64",
                  grad_mode=grad_mode, train_chunk_size=384,
                  hot_features=32, hybrid_cold_max_frac=1.0)
    params.update(over)
    base = Params(action="train", stage="fixed_effect", model_type=model_type,
                  label_column_name="response",
                  prediction_score_column_name="predictionScore")
    return FixedEffectLRModel(FixedLRParams(**params), base)


def _data(seed, n=N, linear=False):
    """Power-law ids (so the hybrid's hot AND cold sides are active), ~30%
    zero-valued entries, positive weights."""
    rng = np.random.RandomState(seed)
    u = rng.rand(n, K)
    idx = (np.minimum(np.exp(u * np.log(D)).astype(int), D) - 1) \
        .astype(np.int32)
    val = rng.randn(n, K) * (rng.rand(n, K) < 0.7)
    y = rng.randn(n) if linear else (rng.rand(n) < 0.5).astype(np.float64)
    return [idx, val, 0.3 * rng.randn(n), y, rng.rand(n) + 0.5]


def _objective(model, arrays, x):
    batch = SparseBatch(*[jnp.asarray(a) for a in arrays])
    aux = model.build_hybrid_aux_for(batch)
    v, g = jax.jit(lambda xx, b, ax: model._objective_fun(b, ax)(xx))(
        jnp.asarray(x), batch, aux)
    return float(v), np.asarray(g), aux


@pytest.mark.parametrize("model_type", ["logistic_regression",
                                        "linear_regression"])
@pytest.mark.parametrize("mode", MODES)
def test_objective_matches_float64_reference(tmp_path, mode, model_type):
    linear = model_type == "linear_regression"
    model = _model(tmp_path, mode, model_type=model_type)
    arrays = _data(1, linear=linear)
    x = np.random.RandomState(2).randn(D + 1) * 0.2
    v, g, aux = _objective(model, arrays, x)
    assert (aux is not None) == (mode == "hybrid")
    if mode == "hybrid":   # both sides of the split carry entries
        assert int(np.sum(np.asarray(aux.cold_val) != 0)) > 0
    v_ref, g_ref = fe_reference(x, *arrays, l2=LAM, model_type=model_type)
    np.testing.assert_allclose(v, v_ref, rtol=1e-10)
    np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_padding_rows_are_inert(tmp_path, mode):
    """Weight-0 rows (any ids, any values) change neither value nor
    gradient, whatever chunk padding the mode adds on top."""
    model = _model(tmp_path, mode)
    arrays = _data(3)
    pad = _data(4, n=200)
    pad[4] = np.zeros(200)
    padded = [np.concatenate([a, b]) for a, b in zip(arrays, pad)]
    x = np.random.RandomState(5).randn(D + 1) * 0.2
    v0, g0, _ = _objective(model, arrays, x)
    v1, g1, _ = _objective(_model(tmp_path, mode), padded, x)
    np.testing.assert_allclose(v1, v0, rtol=1e-12)
    np.testing.assert_allclose(g1, g0, rtol=1e-10, atol=1e-12)


def _largest_collective(compiled_text):
    """Elements of the largest array any cross-device collective outputs."""
    import re
    sizes = [0]
    for line in compiled_text.splitlines():
        m = re.search(r"=(.*?) (all-gather|all-reduce|all-to-all|"
                      r"collective-permute|reduce-scatter)(?:-start)?\(", line)
        if m:
            sizes += [int(np.prod([int(v) for v in dims.split(",") if v]))
                      for dims in re.findall(r"\w+\[([\d,]*)\]", m.group(1))]
    return max(sizes)


@pytest.mark.parametrize("mode", MODES)
def test_objective_rows_split_over_mesh(tmp_path, mode):
    """On the 8-device mesh each device reduces its own rows: the same value
    and gradient as one device, and no collective carries the batch (a
    chunked scan over a sharded batch otherwise gathers all N·K entries to
    every device)."""
    from gdmix_tpu.parallel.mesh import batch_sharding, get_mesh
    arrays = _data(6)
    x = jnp.asarray(np.random.RandomState(7).randn(D + 1) * 0.2)
    out = {}
    for ndev in (1, 8):
        model = _model(tmp_path, mode)
        model.mesh = mesh = get_mesh(jax.devices()[:ndev])
        batch = SparseBatch(*[jax.device_put(a, batch_sharding(mesh, a.ndim))
                              for a in arrays])
        aux = model.build_hybrid_aux_for(batch)
        fun = jax.jit(lambda xx, b, ax, m=model: m._objective_fun(b, ax)(xx))
        biggest = _largest_collective(fun.lower(x, batch, aux).compile()
                                      .as_text())
        assert biggest < (1 if ndev == 1 else N * K // 2), biggest
        out[ndev] = fun(x, batch, aux)
    np.testing.assert_allclose(float(out[8][0]), float(out[1][0]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out[8][1]), np.asarray(out[1][1]),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_float32_fit_per_mode_matches_scipy(tmp_path, mode):
    """End-to-end float32 FE training in each mode reaches the scipy optimum
    (the float64 fits live in test_fixed_effect_lr / test_logistic_ops)."""
    from tests.test_fixed_effect_lr import (_make_dataset, _scipy_fe_oracle,
                                            _train)
    ds = _make_dataset(tmp_path)
    model = _train(ds, tmp_path, grad_mode=mode, dtype="float32",
                   lbfgs_pgtol=1e-6, hot_features=3,
                   hybrid_cold_max_frac=1.0, block_chunk_size=32)
    oracle = _scipy_fe_oracle(ds["X"], ds["y"], ds["offsets"], ds["weights"],
                              lam=0.7, regularize_bias=False)
    np.testing.assert_allclose(model.model_coefficients, oracle, atol=5e-3)


@pytest.mark.parametrize("name,expected", [
    # float32 must be float32-accurate everywhere: HIGH is TF32 on an H100
    ("float32", jax.lax.Precision.HIGHEST),
    ("highest", jax.lax.Precision.HIGHEST),   # the old alias
    ("default", jax.lax.Precision.DEFAULT),
    ("bf16x2", "bf16x2")])
def test_block_precision_map(name, expected):
    assert _PRECISIONS[name] == expected


def test_removed_grad_modes_raise():
    """The removed kernel modes fail fast, naming the modes that exist."""
    for gone in ("pallas", "pallas_block", "pallas_gather", "pallas_flat",
                 "pallas_hybrid"):
        with pytest.raises(ValueError, match="block, onehot, scatter"):
            FixedLRParams(feature_bag="g", grad_mode=gone)
