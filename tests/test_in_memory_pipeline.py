"""In-HBM pipeline tests: must match the file-based workflow's metrics (same
math, no intermediate file I/O) and support multi-sweep coordinate descent."""
import os

import numpy as np
import pytest

from gdmix_tpu.data import movielens
from gdmix_tpu.workflow.config import WorkflowConfig
from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory
from gdmix_tpu.workflow.single_node import run_gdmix_single_node

from tests.test_e2e_pipeline import _config


@pytest.fixture(scope="module")
def ml_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mlmem"))
    data = movielens.generate_synthetic(num_users=100, num_movies=120,
                                        num_ratings=6000, seed=13)
    return movielens.prepare_gdmix_data(root, data)


def test_matches_file_based_workflow(ml_data, tmp_path):
    mem_metrics = run_gdmix_in_memory(_config(ml_data, str(tmp_path / "mem")))
    file_metrics = run_gdmix_single_node(_config(ml_data, str(tmp_path / "file")))
    assert set(mem_metrics) == set(file_metrics)
    for name in mem_metrics:
        # identical math, different plumbing: AUCs agree tightly
        assert abs(mem_metrics[name] - file_metrics[name]) < 2e-3, \
            (name, mem_metrics[name], file_metrics[name])
    # final artifacts exist
    assert os.path.isfile(os.path.join(str(tmp_path / "mem"), "global",
                                       "models", "part-00000.avro"))
    assert os.path.isfile(os.path.join(str(tmp_path / "mem"), "per-movie",
                                       "metric", "evalSummary.json"))


def test_sharded_re_mode_matches_host_mode(ml_data, tmp_path):
    """The multi-chip RE plane (all-to-all routing + on-device grouping
    over the 8-device virtual mesh) must reproduce the host-grouped pipeline:
    same per-coordinate AUC ladder, same exported models."""
    from gdmix_tpu.io.model_avro import load_sparse_models_from_avro
    host_metrics = run_gdmix_in_memory(_config(ml_data, str(tmp_path / "h")),
                                       re_mode="host")
    shard_metrics = run_gdmix_in_memory(_config(ml_data, str(tmp_path / "s")),
                                        re_mode="sharded")
    assert set(host_metrics) == set(shard_metrics)
    # same optimum reached through different summation orders (compact vs
    # global indexing) in f32 — tight but not bit-identical (the f64
    # model-for-model equality lives in test_sharded_re.py)
    for name in host_metrics:
        assert abs(host_metrics[name] - shard_metrics[name]) < 1e-4, \
            (name, host_metrics[name], shard_metrics[name])
    for coord, bag in (("per-user", "per_user"), ("per-movie", "per_movie")):
        ff = os.path.join(ml_data, bag, "featureList", bag)
        h = load_sparse_models_from_avro(
            os.path.join(str(tmp_path / "h"), coord, "models",
                         "part-00000.avro"), ff)
        s = load_sparse_models_from_avro(
            os.path.join(str(tmp_path / "s"), coord, "models",
                         "part-00000.avro"), ff)
        assert set(h) == set(s)
        for eid in h:
            np.testing.assert_allclose(s[eid].theta, h[eid].theta, atol=1e-3,
                                       err_msg=f"{coord}/{eid}")


def test_cli_default_routes_sharded(ml_data, tmp_path, monkeypatch):
    """A plain `--mode in_memory` CLI run takes the multi-chip sharded RE
    plane BY DEFAULT on the 8-device virtual mesh (fit_records_sharded is
    the user-reachable production path, matching the reference where the
    partitioned plane is the default, random_effect_driver.py:60-68 — not an
    opt-in), and --re_mode host opts out."""
    import yaml
    from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu.workflow.main import main
    calls = []
    orig = RandomEffectLRModel.fit_records_sharded

    def spy(self, *a, **kw):
        calls.append(self.model_params.partition_entity)
        return orig(self, *a, **kw)

    monkeypatch.setattr(RandomEffectLRModel, "fit_records_sharded", spy)
    cfg = _config(ml_data, str(tmp_path / "out"))
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"output_dir": cfg.output_dir,
                        "fixed_effect_config": cfg.fixed_effect_config,
                        "random_effect_config": cfg.random_effect_config},
                       f, sort_keys=False)
    metrics = main(["--config_path", cfg_path, "--mode", "in_memory"])
    assert calls == ["user_id", "movie_id"]   # both RE coordinates sharded
    assert metrics["per-movie"] > metrics["global"]   # ladder still climbs
    # --re_mode host opts out of the device plane
    calls.clear()
    main(["--config_path", cfg_path, "--mode", "in_memory",
          "--re_mode", "host"])
    assert calls == []
    # a YAML top-level re_mode key is honored too
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"output_dir": cfg.output_dir,
                        "fixed_effect_config": cfg.fixed_effect_config,
                        "random_effect_config": cfg.random_effect_config,
                        "re_mode": "sharded"}, f, sort_keys=False)
    calls.clear()
    main(["--config_path", cfg_path, "--mode", "in_memory"])
    assert calls == ["user_id", "movie_id"]


def test_auto_single_device_routes_host(ml_data, tmp_path, monkeypatch):
    """re_mode=auto means ONE thing everywhere: on a
    1-device mesh BOTH InMemoryPipeline._use_sharded_re and
    RandomEffectLRModel.fit_flat take the measured-faster host plane
    (fit_groups); on the default 8-device mesh both take the sharded plane
    (asserted by test_cli_default_routes_sharded)."""
    import jax
    import gdmix_tpu.models.random_effect_lr as RE
    import gdmix_tpu.parallel.mesh as mesh_mod
    from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel

    def one_dev(*a, **k):
        return mesh_mod.Mesh(np.array(jax.devices()[:1]),
                             (mesh_mod.DATA_AXIS,))

    monkeypatch.setattr(mesh_mod, "get_mesh", one_dev)
    monkeypatch.setattr(RE, "get_mesh", one_dev)
    sharded, host = [], []
    orig_sharded = RandomEffectLRModel.fit_records_sharded
    orig_groups = RandomEffectLRModel.fit_groups
    monkeypatch.setattr(
        RandomEffectLRModel, "fit_records_sharded",
        lambda self, *a, **k: sharded.append(1) or orig_sharded(self, *a, **k))
    monkeypatch.setattr(
        RandomEffectLRModel, "fit_groups",
        lambda self, *a, **k: host.append(1) or orig_groups(self, *a, **k))

    # pipeline-auto: a plain in_memory run on one device stays on host
    run_gdmix_in_memory(_config(ml_data, str(tmp_path / "auto1")))
    assert sharded == [] and len(host) > 0

    # model-auto: fit_flat makes the same call on the same mesh
    from gdmix_tpu.data.bucketing import FlatGroups
    from tests.test_random_effect_lr import (_build_model, _make_groups,
                                             _write_dataset)
    sharded.clear(), host.clear()
    groups, _ = _make_groups(num_entities=3, seed=7)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    model, base = _build_model(md_file, train_dir, feature_file, tmp_path,
                               re_mode="auto")
    counts = np.array([len(g.columns["response"]) for g in groups], np.int64)
    K = max(len(ix) for g in groups for ix in g.ragged_indices)
    fg = FlatGroups(
        entity_ids=np.array([g.entity_id for g in groups], object),
        counts=counts,
        columns={k: np.concatenate([g.columns[k] for g in groups])
                 for k in groups[0].columns},
        indices=np.vstack([
            np.array([np.pad(ix, (0, K - len(ix))) for ix in
                      g.ragged_indices], np.int64) for g in groups]),
        values=np.vstack([
            np.array([np.pad(v, (0, K - len(v))) for v in
                      g.ragged_values]) for g in groups]),
        rec_nnz=np.concatenate([
            np.array([len(ix) for ix in g.ragged_indices], np.int64)
            for g in groups]))
    model.fit_flat(fg, {}, base)
    assert sharded == [] and len(host) == 1


def test_multi_sweep_improves_or_holds(ml_data, tmp_path):
    one = run_gdmix_in_memory(_config(ml_data, str(tmp_path / "s1")),
                              num_sweeps=1)
    two = run_gdmix_in_memory(_config(ml_data, str(tmp_path / "s2")),
                              num_sweeps=2)
    # After a second sweep the final coordinate's AUC must not regress
    # (coordinate descent on a convex-per-block objective).
    assert two["per-movie"] >= one["per-movie"] - 1e-3


def test_linear_regression_random_effect_rejected(ml_data, tmp_path):
    """All three entry points enforce the reference's logistic-only random
    effects (model_factory.py:46-47): the factory, the single-node workflow
    (BEFORE the partition job runs), and the in-memory pipeline."""
    import copy
    from gdmix_tpu import constants
    from gdmix_tpu.drivers.factory import get_model
    from gdmix_tpu.params import Params, from_dict

    wf = copy.deepcopy(_config(ml_data, str(tmp_path / "out")))
    per_user = wf.random_effect_config["per-user"]
    per_user["gdmix_config"] = dict(per_user["gdmix_config"],
                                    model_type="linear_regression")
    with pytest.raises(ValueError, match="logistic_regression"):
        run_gdmix_single_node(wf)
    # single_node must reject before creating the coordinate's output dirs
    assert not os.path.isdir(os.path.join(str(tmp_path / "out"), "per-user",
                                          "partition"))
    with pytest.raises(ValueError, match="logistic_regression"):
        run_gdmix_in_memory(wf)
    base = from_dict(Params, {"stage": constants.RANDOM_EFFECT,
                              "model_type": "linear_regression",
                              "label_column_name": "response"})
    with pytest.raises(ValueError, match="random effect"):
        get_model(base, [])
