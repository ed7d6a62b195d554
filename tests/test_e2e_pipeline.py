"""End-to-end movieLens-style pipeline: fixed effect → per-user RE → per-movie RE,
driven by the reference YAML config dialect. The acceptance criterion mirrors the
reference's CI e2e (movieLens AUC table, README.md:295-299): each coordinate must
lift validation AUC."""
import os

import numpy as np
import pytest

from gdmix_tpu.data import movielens
from gdmix_tpu.workflow.config import WorkflowConfig
from gdmix_tpu.workflow.single_node import run_gdmix_single_node


@pytest.fixture(scope="module")
def ml_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ml"))
    data = movielens.generate_synthetic(num_users=120, num_movies=150,
                                        num_ratings=8000, seed=3)
    return movielens.prepare_gdmix_data(root, data)


def _config(ml_root, out_dir):
    gdmix_config = {
        "model_type": "logistic_regression",
        "label_column_name": "response",
        "uid_column_name": "uid",
        "prediction_score_column_name": "predictionScore",
        "weight_column_name": "weight",
    }
    def coord(bag, extra=None):
        c = {
            "training_data_dir": os.path.join(ml_root, bag, "trainingData"),
            "validation_data_dir": os.path.join(ml_root, bag, "validationData"),
            "feature_file": os.path.join(ml_root, bag, "featureList", bag),
            "feature_bag": bag,
            "metadata_file": os.path.join(ml_root, bag, "metadata",
                                          "tensor_metadata.json"),
            "l2_reg_weight": 1.0,
            "regularize_bias": False,
            "lbfgs_tolerance": 1.0e-12,
            "num_of_lbfgs_iterations": 100,
            "num_of_lbfgs_curvature_pairs": 10,
            "gdmix_config": gdmix_config,
        }
        c.update(extra or {})
        return c

    return WorkflowConfig.from_dict({
        "output_dir": out_dir,
        "fixed_effect_config": {"global": coord("global")},
        "random_effect_config": {
            "per-user": coord("per_user", {"partition_entity": "user_id",
                                           "num_partitions": 2}),
            "per-movie": coord("per_movie", {"partition_entity": "movie_id",
                                             "num_partitions": 1}),
        },
    })


def test_full_lr_pipeline_auc_lift(ml_data, tmp_path):
    out_dir = str(tmp_path / "lr-training")
    metrics = run_gdmix_single_node(_config(ml_data, out_dir))
    assert set(metrics) == {"global", "per-user", "per-movie"}
    print("pipeline metrics:", metrics)
    # planted mixed effects → each coordinate must add AUC
    assert metrics["global"] > 0.55
    assert metrics["per-user"] > metrics["global"] + 0.01
    assert metrics["per-movie"] > metrics["per-user"]
    # artifacts of the directory contract
    assert os.path.isfile(os.path.join(out_dir, "global", "models",
                                       "part-00000.avro"))
    assert os.path.isfile(os.path.join(out_dir, "per-user", "partition",
                                       "partitionList.txt"))
    assert os.path.isfile(os.path.join(out_dir, "per-movie", "metric",
                                       "evalSummary.json"))


def test_yaml_config_compatibility(tmp_path):
    """The reference workflow's lr-movieLens.yaml dialect (anchors and merge
    keys included) parses into our WorkflowConfig."""
    cfg = WorkflowConfig.from_file(os.path.join(
        os.path.dirname(__file__), "resources", "lr-movieLens.yaml"))
    assert list(cfg.fixed_effect_config) == ["global"]
    assert list(cfg.random_effect_config) == ["per-user", "per-movie"]
    g = cfg.fixed_effect_config["global"]
    assert g["gdmix_config"]["label_column_name"] == "response"
    assert g["gdmix_config"]["weight_column_name"] == "weight"
    assert g["l2_reg_weight"] == 1.0            # merged from the anchor
    user = cfg.random_effect_config["per-user"]
    assert user["num_partitions"] == 1
    assert user["gdmix_config"] == cfg.extras["gdmix_config"]
    assert cfg.extras["tfjob_config"]["workerNum"] == 2


def test_resume_skips_completed_coordinates(ml_data, tmp_path):
    """--resume restarts a crashed pipeline from the first unfinished
    coordinate: completed coordinates keep their outputs untouched and their
    recorded metrics; wiped ones re-run to the same result."""
    import shutil

    out_dir = str(tmp_path / "lr-training")
    cfg = _config(ml_data, out_dir)
    first = run_gdmix_single_node(cfg)

    # mtime fingerprint of the completed coordinates' model files
    def fingerprint(name):
        p = os.path.join(out_dir, name, "models", "part-00000.avro")
        return os.path.getmtime(p)

    fp_global = fingerprint("global")
    fp_user = fingerprint("per-user")
    # simulate a crash during the last coordinate
    shutil.rmtree(os.path.join(out_dir, "per-movie"))

    second = run_gdmix_single_node(cfg, resume=True)
    assert second["global"] == first["global"]
    assert second["per-user"] == first["per-user"]
    assert second["per-movie"] == pytest.approx(first["per-movie"], abs=1e-9)
    # completed coordinates were not re-run (outputs untouched)
    assert fingerprint("global") == fp_global
    assert fingerprint("per-user") == fp_user
