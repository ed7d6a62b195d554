"""DeText-style pipeline e2e: deep fixed-effect tower → per-user → per-movie REs
(the reference's second headline pipeline, README.md:312-316)."""
import os

import numpy as np
import pytest

from gdmix_tpu.data import movielens
from gdmix_tpu.workflow.config import WorkflowConfig
from gdmix_tpu.workflow.single_node import run_gdmix_single_node


def test_detext_pipeline_auc_lift(tmp_path):
    root = str(tmp_path)
    data = movielens.generate_synthetic(num_users=80, num_movies=100,
                                        num_ratings=6000, seed=5)
    ml = movielens.prepare_gdmix_data(root, data, with_detext=True)
    detext = os.path.join(ml, "detext")

    gdmix_config = {
        "model_type": "detext",
        "label_column_name": "response",
        "uid_column_name": "uid",
        "prediction_score_column_name": "predictionScore",
        "weight_column_name": "weight",
    }
    re_gdmix_config = dict(gdmix_config, model_type="logistic_regression")

    def re_coord(bag, entity):
        return {
            "training_data_dir": os.path.join(ml, bag, "trainingData"),
            "validation_data_dir": os.path.join(ml, bag, "validationData"),
            "feature_file": os.path.join(ml, bag, "featureList", bag),
            "feature_bag": bag,
            "metadata_file": os.path.join(ml, bag, "metadata",
                                          "tensor_metadata.json"),
            "l2_reg_weight": 1.0,
            "regularize_bias": False,
            "partition_entity": entity,
            "num_partitions": 1,
            "gdmix_config": re_gdmix_config,
        }

    cfg = WorkflowConfig.from_dict({
        "output_dir": os.path.join(root, "detext-training"),
        "fixed_effect_config": {"global": {
            "training_data_dir": os.path.join(detext, "trainingData"),
            "validation_data_dir": os.path.join(detext, "validationData"),
            "metadata_file": os.path.join(detext, "metadata",
                                          "tensor_metadata.json"),
            "vocab_file": os.path.join(detext, "vocab.txt"),
            "feature_bag": "wide_ftrs_sp",
            "num_epochs": 5,
            "batch_size": 256,
            "num_units": 16,
            "num_filters": 8,
            "num_hidden": 16,
            "learning_rate": 0.02,
            "gdmix_config": gdmix_config,
        }},
        "random_effect_config": {
            "per-user": re_coord("per_user", "user_id"),
            "per-movie": re_coord("per_movie", "movie_id"),
        },
    })

    metrics = run_gdmix_single_node(cfg)
    print("detext pipeline metrics:", metrics)
    assert metrics["global"] > 0.55
    assert metrics["per-user"] > metrics["global"]
    assert metrics["per-movie"] > metrics["per-user"]


def test_detext_pipeline_on_remote_scheme(tmp_path):
    """The detext coordinate's FULL operational surface on a remote scheme
   : output_dir = mem:// — the deep tower's orbax
    checkpoint uploads dir-wise through the fs seam, its scores land on the
    fake remote, and the downstream RE consumes them from there."""
    from gdmix_tpu.io import fs as fslib
    root = str(tmp_path)
    data = movielens.generate_synthetic(num_users=50, num_movies=60,
                                        num_ratings=3000, seed=7)
    ml = movielens.prepare_gdmix_data(root, data, with_detext=True)
    detext = os.path.join(ml, "detext")

    gdmix_config = {
        "model_type": "detext",
        "label_column_name": "response",
        "uid_column_name": "uid",
        "prediction_score_column_name": "predictionScore",
        "weight_column_name": "weight",
    }
    re_gdmix_config = dict(gdmix_config, model_type="logistic_regression")
    out_dir = "mem://bkt/detext-training"
    cfg = WorkflowConfig.from_dict({
        "output_dir": out_dir,
        "fixed_effect_config": {"global": {
            "training_data_dir": os.path.join(detext, "trainingData"),
            "validation_data_dir": os.path.join(detext, "validationData"),
            "metadata_file": os.path.join(detext, "metadata",
                                          "tensor_metadata.json"),
            "vocab_file": os.path.join(detext, "vocab.txt"),
            "feature_bag": "wide_ftrs_sp",
            "num_epochs": 3,
            "batch_size": 256,
            "num_units": 16,
            "num_filters": 8,
            "num_hidden": 16,
            "learning_rate": 0.02,
            "gdmix_config": gdmix_config,
        }},
        "random_effect_config": {
            "per-user": {
                "training_data_dir": os.path.join(ml, "per_user",
                                                  "trainingData"),
                "validation_data_dir": os.path.join(ml, "per_user",
                                                    "validationData"),
                "feature_file": os.path.join(ml, "per_user", "featureList",
                                             "per_user"),
                "feature_bag": "per_user",
                "metadata_file": os.path.join(ml, "per_user", "metadata",
                                              "tensor_metadata.json"),
                "l2_reg_weight": 1.0,
                "regularize_bias": False,
                "partition_entity": "user_id",
                "num_partitions": 1,
                "gdmix_config": re_gdmix_config,
            },
        },
    })
    try:
        metrics = run_gdmix_single_node(cfg)
        assert metrics["global"] > 0.52
        assert metrics["per-user"] > metrics["global"]
        # deep-tower checkpoint landed on the remote scheme, dir-wise
        assert fslib.isfile(out_dir + "/global/models/deep_tower_ckpt/"
                            "manifest.json")
        assert fslib.isdir(out_dir + "/global/models/deep_tower_ckpt/params")
        # and restores FROM the remote scheme (download_dir path)
        from gdmix_tpu.models.deep_tower import DeepTowerModel, \
            DeepTowerParams
        from gdmix_tpu.params import Params
        params = DeepTowerParams(
            metadata_file=os.path.join(detext, "metadata",
                                       "tensor_metadata.json"),
            output_model_dir=out_dir + "/global/models",
            vocab_file=os.path.join(detext, "vocab.txt"),
            num_units=16, num_filters=8, num_hidden=16)
        base = Params(action="inference", stage="fixed_effect",
                      model_type="detext", label_column_name="response",
                      uid_column_name="uid",
                      prediction_score_column_name="predictionScore")
        m = DeepTowerModel(params, base)
        m._load_checkpoint()
        assert m.params_tree is not None
    finally:
        fslib._registry.pop("mem", None)
