"""Workflow CLI / job-CLI / DAG tests (reference test_workflow_generator.py style:
job sequences asserted as data) plus a full CLI-driven pipeline run."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gdmix_tpu.data import movielens
from gdmix_tpu.workflow.config import WorkflowConfig
from gdmix_tpu.workflow.distributed import generate_job_dag

from tests.test_e2e_pipeline import _config


def test_job_dag_sequence(tmp_path):
    cfg = _config("/data/movieLens", str(tmp_path / "out"))
    dag = generate_job_dag(cfg)
    names = [j["name"] for j in dag]
    assert names == [
        "global-tf-train", "global-compute-metric",
        "per-user-partition", "per-user-tf-train", "per-user-compute-metric",
        "per-movie-partition", "per-movie-tf-train", "per-movie-compute-metric",
    ]
    deps = {j["name"]: j["depends_on"] for j in dag}
    assert deps["per-user-partition"] == ["global-compute-metric"]
    assert deps["per-movie-partition"] == ["per-user-compute-metric"]
    assert dag[0]["command"][:3] == ["python", "-m", "gdmix_tpu.gdmix"]


def test_workflow_main_in_memory(tmp_path):
    """End-to-end through the workflow CLI entry (in-process call)."""
    import yaml
    root = str(tmp_path)
    data = movielens.generate_synthetic(num_users=50, num_movies=60,
                                        num_ratings=3000, seed=21)
    ml = movielens.prepare_gdmix_data(root, data)
    cfg = _config(ml, os.path.join(root, "out"))
    cfg_file = os.path.join(root, "config.yaml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump({"output_dir": cfg.output_dir,
                        "fixed_effect_config": cfg.fixed_effect_config,
                        "random_effect_config": cfg.random_effect_config}, f)

    from gdmix_tpu.workflow.main import main
    metrics = main(["--config_path", cfg_file, "--mode", "in_memory"])
    assert set(metrics) == {"global", "per-user", "per-movie"}
    assert metrics["per-movie"] > metrics["global"]


def test_jobs_cli_evaluator(tmp_path):
    from gdmix_tpu.io.scores import write_scores
    from gdmix_tpu.params import SchemaParams
    sp = SchemaParams(uid_column_name="uid", label_column_name="response",
                      prediction_score_column_name="predictionScore")
    rng = np.random.RandomState(0)
    y = rng.randint(0, 2, 100).astype(float)
    s = rng.randn(100) + y
    sdir = str(tmp_path / "scores")
    write_scores(os.path.join(sdir, "p.avro"), sp, np.arange(100), s, labels=y)
    out = str(tmp_path / "metric")

    from gdmix_tpu.workflow.jobs import main as jobs_main
    jobs_main(["evaluator", "--metricsInputDir", sdir,
               "--outputMetricFile", out])
    with open(os.path.join(out, "evalSummary.json")) as f:
        assert 0.5 < json.load(f)["auc"] <= 1.0


def test_compile_dag_cli(tmp_path):
    import yaml
    cfg = _config("/data/ml", str(tmp_path / "out"))
    cfg_file = str(tmp_path / "c.yaml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump({"output_dir": cfg.output_dir,
                        "fixed_effect_config": cfg.fixed_effect_config,
                        "random_effect_config": cfg.random_effect_config}, f)
    dag_file = str(tmp_path / "dag.json")
    from gdmix_tpu.workflow.main import main
    main(["--config_path", cfg_file, "--compile_dag_to", dag_file])
    with open(dag_file) as f:
        dag = json.load(f)
    assert len(dag["jobs"]) == 8


def test_jobs_cli_offset_updater_and_metadata_generator(tmp_path):
    """6/6 data-job parity: the standalone OffsetUpdater iterating loop
    (OffsetUpdater.scala:30-91 — offset = score − perCoordinate joined on uid)
    and MetadataGenerator schema derivation (MetadataGenerator.scala:59-82)."""
    from gdmix_tpu.io.input_pipeline import read_per_record, write_per_record
    from gdmix_tpu.io.metadata import DatasetMetadata
    from gdmix_tpu.io.scores import write_scores
    from gdmix_tpu.params import Params
    from gdmix_tpu.workflow import jobs

    root = str(tmp_path)
    rng = np.random.RandomState(0)
    n, d = 12, 4
    md_json = {"features": [
        {"name": "global", "dtype": "float", "shape": [d], "isSparse": True},
        {"name": "uid", "dtype": "long", "shape": [], "isSparse": False}],
        "labels": [{"name": "response", "dtype": "int", "shape": [],
                    "isSparse": False}]}
    md_file = os.path.join(root, "md.json")
    with open(md_file, "w") as f:
        json.dump(md_json, f)
    md = DatasetMetadata.from_file(md_file)
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir)
    uids = rng.permutation(n).astype(np.int64)
    write_per_record(os.path.join(data_dir, "d.tfrecord"), md,
                     {"uid": uids, "response": rng.randint(0, 2, n)},
                     "global", [np.array([i % d]) for i in range(n)],
                     [np.array([1.5]) for _ in range(n)])
    sp = Params(action="train", stage="fixed_effect",
                label_column_name="response", uid_column_name="uid",
                prediction_score_column_name="predictionScore")
    score_uids = np.arange(n, dtype=np.int64)
    scores = rng.randn(n)
    pc = 0.1 * rng.randn(n)
    write_scores(os.path.join(root, "scores", "part-00000.avro"), sp,
                 score_uids, scores, scores_per_coordinate=pc)

    out_dir = os.path.join(root, "out")
    out_md = os.path.join(root, "out_md.json")
    jobs.main(["offset-updater",
               "--trainingDataDir", data_dir,
               "--trainingScoreDir", os.path.join(root, "scores"),
               "--trainingScorePerCoordinateDir", os.path.join(root, "scores"),
               "--outputTrainingDataDir", out_dir,
               "--metadataFile", md_file,
               "--outputMetadataFile", out_md,
               "--featureBag", "global"])
    out_metadata = DatasetMetadata.from_file(out_md)
    assert "offset" in out_metadata.feature_names
    got = read_per_record(out_dir, out_metadata, "global")
    order = np.argsort(got.columns["uid"])
    expected = (scores.astype(np.float32).astype(np.float64) - pc)
    np.testing.assert_allclose(
        got.columns["offset"][order].astype(np.float64),
        expected[np.argsort(score_uids)][got.columns["uid"][order]],
        atol=1e-6)
    # feature bag survives the round trip
    np.testing.assert_allclose(np.sort(got.values[:, 0]), np.full(n, 1.5))

    # metadata-generator: sniff an undeclared column from data
    md2 = {"features": [
        {"name": "uid", "dtype": "long", "shape": [], "isSparse": False}],
        "labels": []}
    md2_file = os.path.join(root, "md2.json")
    with open(md2_file, "w") as f:
        json.dump(md2, f)
    out_md2 = os.path.join(root, "md2_out.json")
    jobs.main(["metadata-generator",
               "--dataDir", out_dir,
               "--inputMetadataFile", md2_file,
               "--outputMetadataFile", out_md2,
               "--extraColumns", "extra_weight:float"])
    got_md = DatasetMetadata.from_file(out_md2)
    for name in ("offset", "response", "extra_weight"):
        assert name in got_md.feature_names, name
    # sparse components of an UNDECLARED bag surface as plain array columns
    assert "global_indices" in got_md.feature_names

    # ...but with the bag declared sparse they are skipped (tfrecord rule)
    out_md3 = os.path.join(root, "md3_out.json")
    jobs.main(["metadata-generator",
               "--dataDir", out_dir,
               "--inputMetadataFile", md_file,
               "--outputMetadataFile", out_md3])
    got_md3 = DatasetMetadata.from_file(out_md3)
    assert "global_indices" not in got_md3.feature_names
    assert "global" in got_md3.feature_names


def test_execute_job_dag_ordering_and_failure(tmp_path):
    """Executor unit semantics: dependency order, parallel ready-set, abort on
    failure (the reference launcher contract, launch_crd.py:31-101)."""
    from gdmix_tpu.workflow.distributed import execute_job_dag
    marker = os.path.join(str(tmp_path), "order.txt")
    def j(name, deps, cmd=None):
        return {"name": name, "type": "t", "depends_on": deps,
                "command": cmd or ["bash", "-c", f"echo {name} >> {marker}"]}
    # diamond: a → (b, c) → d
    order = execute_job_dag([j("d", ["b", "c"]), j("b", ["a"]), j("c", ["a"]),
                             j("a", [])], max_parallel=2)
    assert order[0] == "a" and order[-1] == "d"
    lines = open(marker).read().split()
    assert lines[0] == "a" and lines[-1] == "d" and set(lines) == {"a", "b",
                                                                   "c", "d"}
    with pytest.raises(RuntimeError, match="failed"):
        execute_job_dag([j("ok", []), j("boom", ["ok"],
                                        ["bash", "-c", "exit 3"])])
    with pytest.raises(AssertionError, match="unknown"):
        execute_job_dag([j("x", ["ghost"])])


def test_execute_job_dag_runs_device_jobs_one_at_a_time(tmp_path):
    """A trainer takes every local accelerator and most of its memory, so
    device jobs never overlap even when max_parallel allows it; a data job
    may still run beside one."""
    import time
    from gdmix_tpu.workflow.distributed import execute_job_dag
    log = os.path.join(str(tmp_path), "spans.txt")

    def j(name, typ):
        prog = ("import sys, time; t0 = time.time(); time.sleep(0.6); "
                f"open({log!r}, 'a').write('{name} %f %f\\n' "
                "% (t0, time.time()))")
        return {"name": name, "type": typ, "depends_on": [],
                "command": [sys.executable, "-c", prog]}

    t0 = time.time()
    execute_job_dag([j("train-a", "gdmix_tpu_train"),
                     j("train-b", "gdmix_tpu_train"),
                     j("partition", "gdmix_tpu_partition")], max_parallel=3)
    spans = {}
    for line in open(log):
        name, start, end = line.split()
        spans[name] = (float(start), float(end))
    (a0, a1), (b0, b1) = spans["train-a"], spans["train-b"]
    assert a1 <= b0 or b1 <= a0, spans          # trainers never overlap
    p0, p1 = spans["partition"]
    assert p0 < min(a1, b1), spans              # data job ran beside one
    assert time.time() - t0 < 30


def test_dag_mode_runs_full_pipeline(tmp_path):
    """`--mode dag` executes the COMPLETE generated commands as subprocesses —
    the file-based pipeline driven purely through the DAG (closes the 'DAG is
    emitted but never executed' gap). Asserts the reference AUC-ladder shape
    from the evalSummary.json artifacts."""
    import yaml
    from gdmix_tpu.workflow.main import main as wf_main
    root = str(tmp_path)
    data = movielens.generate_synthetic(num_users=50, num_movies=60,
                                        num_ratings=3000, seed=23)
    ml = movielens.prepare_gdmix_data(root, data)
    out_dir = os.path.join(root, "dag-out")
    cfg = _config(ml, out_dir)
    cfg_path = os.path.join(root, "cfg.yaml")
    with open(cfg_path, "w") as f:
        # sort_keys=False: coordinate order IS the coordinate-descent order
        # (yaml.safe_dump would otherwise alphabetize per-movie before per-user)
        yaml.safe_dump({"output_dir": cfg.output_dir,
                        "fixed_effect_config": cfg.fixed_effect_config,
                        "random_effect_config": cfg.random_effect_config}, f,
                       sort_keys=False)
    result = wf_main(["--config_path", cfg_path, "--mode", "dag"])
    assert len(result["jobs"]) == 8  # fe train+metric, 2×(part+train+metric)
    aucs = {}
    for coord in ("global", "per-user", "per-movie"):
        with open(os.path.join(out_dir, coord, "metric",
                               "evalSummary.json")) as f:
            aucs[coord] = json.load(f)["auc"]
    assert aucs["per-user"] > aucs["global"]
    assert aucs["per-movie"] > aucs["per-user"]
