"""Wire-compact bucket upload (random_effect_lr._compact_bucket_wire +
_expand_shipped): the device-side reconstruction must be bit-identical to
the eager f32 upload for every spec combination — narrowing is only taken
when the host exactness check passes."""
import numpy as np
import jax.numpy as jnp
import pytest

from gdmix_tpu.data.bucketing import EntityBucket
from gdmix_tpu.models.random_effect_lr import (_compact_bucket_wire,
                                               _expand_shipped)


def _bucket(B=12, n=6, K=3, u_cap=20, seed=0, labels01=True, weights01=True,
            zero_offsets=True, zero_theta0=True):
    rng = np.random.RandomState(seed)
    dim = u_cap + 1
    return EntityBucket(
        entity_ids=[f"e{i}" for i in range(B - 2)],  # 2 pow-2 padding rows
        indices=rng.randint(0, u_cap, (B, n, K)).astype(np.int32),
        values=rng.randn(B, n, K).astype(np.float64),
        offsets=(np.zeros((B, n)) if zero_offsets
                 else rng.randn(B, n) * 0.3),
        labels=(rng.randint(0, 2, (B, n)).astype(np.float64) if labels01
                else rng.randn(B, n)),
        weights=(rng.randint(0, 2, (B, n)).astype(np.float64) if weights01
                 else rng.uniform(0.5, 2.0, (B, n))),
        uids=np.arange(B * n, dtype=np.int64).reshape(B, n),
        sample_count=rng.randint(1, n + 1, B).astype(np.int32),
        unique_global_indices=np.zeros((B, u_cap), np.int64),
        u_count=np.full(B, u_cap, np.int32),
        theta0=(np.zeros((B, dim)) if zero_theta0
                else rng.randn(B, dim) * 0.1),
    )


def _eager(bucket, b_ship, b_to, dt=jnp.float32):
    out = dict(
        indices=np.asarray(bucket.indices[:b_ship], np.int32),
        values=np.asarray(bucket.values[:b_ship], np.float32),
        offsets=np.asarray(bucket.offsets[:b_ship], np.float32),
        labels=np.asarray(bucket.labels[:b_ship], np.float32),
        weights=np.asarray(bucket.weights[:b_ship], np.float32),
        sample_count=np.asarray(bucket.sample_count[:b_ship], np.float32),
        theta0=np.asarray(bucket.theta0[:b_ship], np.float32),
    )
    return {k: np.pad(v, ((0, b_to - v.shape[0]),) + ((0, 0),) * (v.ndim - 1))
            for k, v in out.items()}


@pytest.mark.parametrize("labels01,weights01,zero_off,zero_th", [
    (True, True, True, True),      # fully compact (cold start, unweighted)
    (False, False, False, False),  # nothing narrowable (warm, weighted)
    (True, False, True, False),    # mixed
])
def test_roundtrip_bit_identical(labels01, weights01, zero_off, zero_th):
    b = _bucket(labels01=labels01, weights01=weights01,
                zero_offsets=zero_off, zero_theta0=zero_th)
    b_ship, b_to = 10, 16
    shipped, spec = _compact_bucket_wire(b, b_ship)
    got = _expand_shipped(b_to, jnp.float32, spec)(shipped)
    want = _eager(b, b_ship, b_to)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_spec_narrows_only_when_exact():
    cold = _bucket()
    sp = dict(_compact_bucket_wire(cold, 10)[1])
    assert sp["idx"] == "int8" and sp["labels"] == "u8"
    assert sp["values"] == "f32"   # random values never narrow
    assert sp["weights"] == "u8" and sp["offsets"] == "zero"
    assert sp["theta0"] == "zero"
    warm = _bucket(labels01=False, weights01=False, zero_offsets=False,
                   zero_theta0=False)
    sp = dict(_compact_bucket_wire(warm, 10)[1])
    assert sp["labels"] == "f32" and sp["weights"] == "f32"
    assert sp["offsets"] == "f32" and sp["theta0"] == "f32"


def test_binary_feature_values_ship_u8():
    """Indicator bags (values all 0/1, 0 = inert sparse padding) narrow the
    biggest wire column to uint8 and reconstruct bit-identically."""
    import dataclasses
    base = _bucket()
    b = dataclasses.replace(
        base, values=(np.abs(base.values) > 0.5).astype(np.float64))
    shipped, spec = _compact_bucket_wire(b, 10)
    assert dict(spec)["values"] == "u8"
    got = _expand_shipped(16, jnp.float32, spec)(shipped)
    np.testing.assert_array_equal(np.asarray(got["values"]),
                                  _eager(b, 10, 16)["values"])


def test_wide_support_uses_int16_indices():
    b = _bucket(u_cap=300)
    shipped, spec = _compact_bucket_wire(b, 10)
    assert dict(spec)["idx"] == "int16"
    got = _expand_shipped(16, jnp.float32, spec)(shipped)
    np.testing.assert_array_equal(np.asarray(got["indices"]),
                                  _eager(b, 10, 16)["indices"])


def test_wire_bytes_shrink():
    """The compact form of a cold-start 0/1 bucket is a fraction of the
    eager f32 bytes ."""
    b = _bucket(B=64, n=16, K=4)
    shipped, _ = _compact_bucket_wire(b, 64)
    compact = sum(np.asarray(v).nbytes for v in shipped.values())
    eager = sum(v.nbytes for v in _eager(b, 64, 64).values())
    assert compact < 0.5 * eager, (compact, eager)


def _eager_wire(bucket, b_ship, dt=jnp.float32):
    """An eager-f32 stand-in for _compact_bucket_wire: same (shipped, spec)
    contract, but NOTHING is narrowed or dropped — the control arm for the
    bit-identity test below (same expand jit, same solver, same mesh)."""
    shipped = {
        "indices": jnp.asarray(bucket.indices[:b_ship].astype(np.int32)),
        "values": jnp.asarray(bucket.values[:b_ship], dt),
        "labels": jnp.asarray(bucket.labels[:b_ship], dt),
        "weights": jnp.asarray(bucket.weights[:b_ship], dt),
        "offsets": jnp.asarray(bucket.offsets[:b_ship], dt),
        "theta0": jnp.asarray(bucket.theta0[:b_ship], dt),
        "sample_count": jnp.asarray(
            bucket.sample_count[:b_ship].astype(np.int32)),
    }
    spec = {"idx": "int32", "dim": bucket.theta0.shape[1], "values": "f32",
            "labels": "f32", "weights": "f32", "offsets": "f32",
            "theta0": "f32"}
    return shipped, tuple(sorted(spec.items()))


def test_fit_groups_compact_wire_bit_identical_same_mesh(tmp_path,
                                                         monkeypatch):
    """The wire-compact upload's bit-identity claim, tested like-for-like:
    on the SAME 1-device mesh, the compact upload (every narrowing
    exactness-checked on the host) must produce models BIT-IDENTICAL to an
    eager f32 upload — cold start AND warm start (nonzero theta0). The
    solver jit, mesh, and shapes are all held fixed; only the wire encoding
    varies, so any difference is a real leak in _compact_bucket_wire /
    _expand_shipped."""
    import jax
    import gdmix_tpu.models.random_effect_lr as RE
    from gdmix_tpu.parallel.mesh import get_mesh
    from tests.test_random_effect_lr import (_build_model, _make_groups,
                                             _write_dataset)

    groups, _ = _make_groups(num_entities=9, seed=13)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base = _build_model(md_file, train_dir, feature_file, tmp_path)

    monkeypatch.setattr(RE, "get_mesh",
                        lambda *a, **k: get_mesh(jax.devices()[:1]))
    compact = model.fit_groups(groups, {}, base)          # compact spec

    # The warm arms must actually exercise the warm wire (nonzero theta0 on
    # the uplink AND a real solve on the downlink): a converged prior would
    # trip the warm-sweep downlink skip and both arms would reconstruct from
    # host theta0, comparing theta0 against itself. Halve the prior so every
    # bucket moves.
    import dataclasses
    prior = {eid: dataclasses.replace(sm, theta=np.asarray(sm.theta) * 0.5)
             for eid, sm in dict(compact).items()}
    compact_warm = model.fit_groups(groups, dict(prior), base)

    monkeypatch.setattr(RE, "_compact_bucket_wire", _eager_wire)
    eager = model.fit_groups(groups, {}, base)            # eager f32 control
    eager_warm = model.fit_groups(groups, dict(prior), base)
    # the perturbed warm start genuinely moved (guards against the skip
    # silently re-activating and making the warm arms vacuous again)
    assert any(
        not np.array_equal(np.asarray(compact_warm[eid].theta),
                           np.asarray(prior[eid].theta)) for eid in prior)

    assert set(compact) == set(eager)
    for eid in compact:
        np.testing.assert_array_equal(
            np.asarray(compact[eid].theta), np.asarray(eager[eid].theta),
            err_msg=eid)
        np.testing.assert_array_equal(
            np.asarray(compact_warm[eid].theta),
            np.asarray(eager_warm[eid].theta), err_msg=eid)


def test_fit_groups_single_device_mesh_matches_multi(tmp_path, monkeypatch):
    """Cross-MESH consistency: fit_groups on a 1-device mesh (wire-compact
    upload) vs the default multi-device mesh (eager f32, GSPMD-sharded).
    GSPMD legitimately reorders reductions across different meshes, so this
    is an allclose at a documented numerical tolerance (observed cross-mesh
    reduction drift is ~1e-10 in f64; 100x headroom here), NOT bit
    equality — that claim is tested like-for-like above."""
    import jax
    import gdmix_tpu.models.random_effect_lr as RE
    from gdmix_tpu.parallel.mesh import get_mesh
    from tests.test_random_effect_lr import (_build_model, _make_groups,
                                             _write_dataset)

    groups, _ = _make_groups(num_entities=9, seed=13)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base = _build_model(md_file, train_dir, feature_file, tmp_path)
    multi = model.fit_groups(groups, {}, base)

    monkeypatch.setattr(RE, "get_mesh",
                        lambda *a, **k: get_mesh(jax.devices()[:1]))
    single = model.fit_groups(groups, {}, base)          # cold: compact spec
    warm = model.fit_groups(groups, dict(single), base)  # warm: f32 theta0
    assert set(multi) == set(single) == set(warm)
    for eid in multi:
        np.testing.assert_allclose(single[eid].theta, multi[eid].theta,
                                   rtol=1e-8, atol=1e-10, err_msg=eid)
        np.testing.assert_allclose(warm[eid].theta, multi[eid].theta,
                                   rtol=1e-6, atol=1e-8, err_msg=eid)
