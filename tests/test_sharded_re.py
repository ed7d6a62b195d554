"""Multi-chip random-effect path: records routed over the 8-device virtual mesh
to entity-owner shards (parallel/entity_sharding), grouped + packed on device
(ops/segment.build_entity_blocks), solved with the shared cached solver — and
the result must equal the host-grouped fit_groups path model-for-model.

This is the production caller for routing/segment:
the SPMD equivalent of Spark's shuffle-by-entity (DataPartitioner.scala:235-276)
+ fully parallel per-entity training (random_effect_driver.py:60-68)."""
import numpy as np
import pytest

from gdmix_tpu.io.input_pipeline import PerRecordData
from gdmix_tpu.io.model_avro import SparseModel
from gdmix_tpu.parallel.mesh import get_mesh

from tests.test_random_effect_lr import (D, _build_model, _make_groups,
                                         _write_dataset)


def _groups_to_records(groups):
    """Flatten EntityGroups into a PerRecordData (the in-HBM pipeline's form)."""
    cols = {"uid": [], "response": [], "offset": [], "weight": [],
            "user_id": []}
    ragged_i, ragged_v = [], []
    for g in groups:
        n = g.sample_count
        cols["uid"].append(g.columns["uid"])
        cols["response"].append(g.columns["response"])
        cols["offset"].append(g.columns["offset"])
        cols["weight"].append(g.columns["weight"])
        cols["user_id"].extend([g.entity_id] * n)
        for ri, rv in g.iter_ragged():
            ragged_i.append(ri)
            ragged_v.append(rv)
    k = max(max((len(r) for r in ragged_i), default=1), 1)
    n_total = len(ragged_i)
    indices = np.zeros((n_total, k), np.int32)
    values = np.zeros((n_total, k))
    nnz = np.zeros(n_total, np.int32)
    for i, (ri, rv) in enumerate(zip(ragged_i, ragged_v)):
        indices[i, :len(ri)] = ri
        values[i, :len(rv)] = rv
        nnz[i] = len(ri)
    columns = {
        "uid": np.concatenate(cols["uid"]),
        "response": np.concatenate(cols["response"]),
        "offset": np.concatenate(cols["offset"]),
        "weight": np.concatenate(cols["weight"]),
        "user_id": np.asarray(cols["user_id"], dtype=object),
    }
    return PerRecordData(columns=columns, indices=indices, values=values,
                         nnz=nnz, num_samples=n_total)


def _dense(sm: SparseModel):
    """SparseModel → dense [1 + D] coefficient vector (layout-independent)."""
    v = np.zeros(1 + D)
    v[0] = sm.theta[0]
    if len(sm.unique_global_indices):
        v[1 + np.asarray(sm.unique_global_indices)] = sm.theta[1:]
    return v


def _fit_both(tmp_path, groups, prior=None, **over):
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file,
                                      tmp_path, **over)
    host = model.fit_groups(groups, dict(prior or {}), base_params)
    data = _groups_to_records(groups)
    sharded = model.fit_records_sharded(data, base_params,
                                        model_weights=dict(prior or {}),
                                        mesh=get_mesh())
    return host, sharded


def _assert_equal_models(host, sharded, atol=5e-6):
    assert set(host) == set(sharded)
    for eid in host:
        np.testing.assert_allclose(_dense(sharded[eid]), _dense(host[eid]),
                                   atol=atol, err_msg=f"entity {eid}")
        np.testing.assert_array_equal(
            np.sort(sharded[eid].unique_global_indices),
            np.sort(host[eid].unique_global_indices))


def test_sharded_equals_host_path(tmp_path):
    groups, _ = _make_groups(num_entities=23, seed=3)
    host, sharded = _fit_both(tmp_path, groups)
    _assert_equal_models(host, sharded)


def test_sharded_equals_host_path_lbfgs(tmp_path):
    groups, _ = _make_groups(num_entities=11, seed=4)
    host, sharded = _fit_both(tmp_path, groups, batch_solver="lbfgs")
    _assert_equal_models(host, sharded)


def test_sharded_skewed_entity_sizes(tmp_path):
    """One giant entity (n_cap stress) among tiny ones; fewer entities than
    shards on some devices."""
    rng = np.random.RandomState(9)
    groups, _ = _make_groups(num_entities=5, seed=5)
    # inflate entity 0 to 150 records
    from gdmix_tpu.io.input_pipeline import EntityGroup
    n = 150
    ragged_i = [np.sort(rng.choice(D, rng.randint(1, D + 1), replace=False))
                for _ in range(n)]
    ragged_v = [rng.randn(len(r)) for r in ragged_i]
    y = rng.randint(0, 2, n).astype(np.float64)
    big = EntityGroup(
        entity_id="99999",
        columns={"uid": np.arange(10_000, 10_000 + n, dtype=np.int64),
                 "response": y,
                 "offset": np.zeros(n, np.float32),
                 "weight": np.ones(n, np.float32)},
        ragged_indices=ragged_i, ragged_values=ragged_v)
    groups = groups + [big]
    host, sharded = _fit_both(tmp_path, groups)
    _assert_equal_models(host, sharded)


def test_sharded_warm_start_reconciliation(tmp_path):
    """Prior models (including one with out-of-support features and one for an
    entity absent from the data) reconcile identically; prior-only entities
    carry forward untouched."""
    groups, _ = _make_groups(num_entities=9, seed=6)
    prior = {
        groups[0].entity_id: SparseModel(
            model_id=groups[0].entity_id,
            theta=np.array([0.5, 0.3, -0.2]), variance=None,
            unique_global_indices=np.array([0, D - 1])),
        "ghost-entity": SparseModel(
            model_id="ghost-entity", theta=np.array([1.0, 2.0]),
            variance=None, unique_global_indices=np.array([2])),
    }
    host, sharded = _fit_both(tmp_path, groups, prior=prior)
    assert "ghost-entity" in sharded
    np.testing.assert_array_equal(sharded["ghost-entity"].theta,
                                  prior["ghost-entity"].theta)
    _assert_equal_models(host, sharded)


def test_sharded_variance(tmp_path):
    groups, _ = _make_groups(num_entities=7, seed=7)
    host, sharded = _fit_both(tmp_path, groups,
                              random_effect_variance_mode="full")
    assert set(host) == set(sharded)
    for eid in host:
        hv = np.zeros(1 + D)
        sv = np.zeros(1 + D)
        hv[0], sv[0] = host[eid].variance[0], sharded[eid].variance[0]
        hv[1 + np.asarray(host[eid].unique_global_indices)] = \
            host[eid].variance[1:]
        sv[1 + np.asarray(sharded[eid].unique_global_indices)] = \
            sharded[eid].variance[1:]
        np.testing.assert_allclose(sv, hv, rtol=1e-5, atol=1e-8,
                                   err_msg=f"entity {eid}")


def test_sharded_heavy_tail_tiers(tmp_path):
    """Pareto-style entity sizes spanning several power-of-two n_cap tiers
   : the sharded plane must tier instead of padding every
    slot to the 200-record giant, and still equal the host path model-for-
    model — including a warm start that reconciles across tiers."""
    from gdmix_tpu.io.input_pipeline import EntityGroup
    rng = np.random.RandomState(13)
    sizes = [1, 2, 3, 5, 7, 9, 14, 17, 33, 40, 70, 90, 200]
    groups = []
    uid = 0
    for e, n in enumerate(sizes):
        ragged_i = [np.sort(rng.choice(D, rng.randint(1, D + 1),
                                       replace=False)) for _ in range(n)]
        ragged_v = [rng.randn(len(r)) for r in ragged_i]
        y = rng.randint(0, 2, n).astype(np.float64)
        if n > 1 and y.min() == y.max():
            y[0], y[-1] = 0.0, 1.0
        groups.append(EntityGroup(
            entity_id=str(1000 + e),
            columns={"uid": np.arange(uid, uid + n, dtype=np.int64),
                     "response": y,
                     "offset": 0.1 * rng.randn(n),
                     "weight": np.ones(n)},
            ragged_indices=ragged_i, ragged_values=ragged_v))
        uid += n
    # multiple tiers must actually exist for this workload
    from gdmix_tpu.data.bucketing import _sample_caps
    caps = _sample_caps(np.asarray(sizes), 8)
    assert len(set(np.searchsorted(caps, sizes))) >= 3
    prior = {groups[0].entity_id: SparseModel(
        model_id=groups[0].entity_id, theta=np.array([0.2, 0.1]),
        variance=None, unique_global_indices=np.array([1]))}
    host, sharded = _fit_both(tmp_path, groups, prior=prior)
    _assert_equal_models(host, sharded)


def test_sharded_single_device_mesh(tmp_path):
    """P=1 degenerate mesh: all_to_all over a singleton axis must be identity."""
    import jax
    groups, _ = _make_groups(num_entities=4, seed=8)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file,
                                      tmp_path)
    host = model.fit_groups(groups, {}, base_params)
    data = _groups_to_records(groups)
    mesh1 = get_mesh([jax.devices()[0]])
    sharded = model.fit_records_sharded(data, base_params, mesh=mesh1)
    _assert_equal_models(host, sharded)


def test_sharded_wide_support_dense_path(tmp_path):
    """Global feature space wider than newton_max_dim: the sharded plane's
    LOCAL indexing must keep each entity's solve in its compact support space
    (dim ≤ 12 here, not the 141-wide global space) and still agree with the
    host bucket path model-for-model — the support coefficients land back on
    the right GLOBAL ids."""
    width = 140  # dim = 141 > newton_max_dim=128 -> dense L-BFGS under "auto"
    groups, _ = _make_groups(num_entities=9, seed=11, width=width,
                             max_support=12)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups,
                                                      width=width)
    model, base_params = _build_model(md_file, train_dir, feature_file,
                                      tmp_path)
    host = model.fit_groups(groups, {}, base_params)
    data = _groups_to_records(groups)
    sharded = model.fit_records_sharded(data, base_params, mesh=get_mesh())
    assert set(host) == set(sharded)
    for eid in host:
        hv = np.zeros(1 + width)
        sv = np.zeros(1 + width)
        hv[0], sv[0] = host[eid].theta[0], sharded[eid].theta[0]
        hv[1 + np.asarray(host[eid].unique_global_indices)] = \
            host[eid].theta[1:]
        sv[1 + np.asarray(sharded[eid].unique_global_indices)] = \
            sharded[eid].theta[1:]
        np.testing.assert_allclose(sv, hv, atol=5e-6, err_msg=f"entity {eid}")


def test_fit_flat_sharded_entity_order_not_sorted(tmp_path):
    """fit_flat's sharded plane factorizes entity ids (sorted) while the
    FlatGroups records stay in their own entity order. Every entity must
    still get the model of its own records: equal to the host plane's
    fit."""
    from gdmix_tpu.data.bucketing import FlatGroups
    groups, _ = _make_groups(num_entities=12, seed=21)
    groups = groups[::-1]      # "111", "110", ...: not sorted order
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file,
                                      tmp_path)
    data = _groups_to_records(groups)
    counts = np.array([g.sample_count for g in groups], np.int64)
    assert list(np.argsort([g.entity_id for g in groups])) \
        != list(range(len(groups)))
    k = data.indices.shape[1]
    fg = FlatGroups(entity_ids=np.array([g.entity_id for g in groups],
                                        object),
                    counts=counts,
                    columns={c: data.columns[c] for c in
                             ("uid", "response", "offset", "weight")},
                    indices=data.indices, values=data.values,
                    rec_nnz=data.nnz)
    assert fg.indices.shape[1] == k
    model.model_params.re_mode = "host"
    host = model.fit_flat(fg, {}, base_params)
    model.model_params.re_mode = "sharded"
    sharded = model.fit_flat(fg, {}, base_params)
    _assert_equal_models(dict(host), dict(sharded))


@pytest.mark.parametrize("ndev", [1, 4])
def test_model_mesh_sets_devices_and_plane(tmp_path, ndev):
    """A model built on a mesh fits there: re_mode=auto takes the host plane
    on one device and the sharded plane on several, and both equal the host
    plane on every device."""
    import jax
    from gdmix_tpu.data.bucketing import FlatGroups
    from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel
    groups, _ = _make_groups(num_entities=16, seed=22)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base_params = _build_model(md_file, train_dir, feature_file,
                                      tmp_path, re_mode="auto")
    data = _groups_to_records(groups)
    fg = FlatGroups(entity_ids=np.array([g.entity_id for g in groups],
                                        object),
                    counts=np.array([g.sample_count for g in groups]),
                    columns={c: data.columns[c] for c in
                             ("uid", "response", "offset", "weight")},
                    indices=data.indices, values=data.values,
                    rec_nnz=data.nnz)
    want = model.fit_groups(fg, {}, base_params)
    on_mesh = RandomEffectLRModel(model.model_params, base_params,
                                  mesh=get_mesh(jax.devices()[:ndev]))
    got = on_mesh.fit_flat(fg, {}, base_params)
    assert on_mesh.last_fit_plane == ("host" if ndev == 1 else "sharded")
    _assert_equal_models(dict(want), dict(got))
