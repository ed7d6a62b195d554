"""Wall-clock the full 3-coordinate pipelines on the host backend.

Compares against the reference's CPU wall clocks (~2 min LR pipeline, ~3 min
DeText pipeline on 16 Xeon cores — reference README.md:238,310): synthetic
movieLens-100k shape
(943 users, 1682 movies, 100k ratings), cold = first run in a fresh
process (includes every jit compile), warm = second run in the same
process (live jit caches, fresh output dir).

    python scripts/time_pipeline.py lr       # in_memory + single_node file mode
    python scripts/time_pipeline.py detext   # deep-tower FE -> per-user -> per-movie

Host-only by design: the host backend is the apples-to-apples comparison
against the reference's CPU wall clocks (chip_smoke.py runs the same pipeline
on the GPU).
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"  # assign, not setdefault
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gdmix_tpu.data import movielens  # noqa: E402
from gdmix_tpu.workflow.config import WorkflowConfig  # noqa: E402
from gdmix_tpu.workflow.single_node import run_gdmix_single_node  # noqa: E402

USERS, MOVIES, RATINGS = 943, 1682, 100_000


def _re_coord(ml, bag, entity, gdmix_config):
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
        "gdmix_config": dict(gdmix_config,
                             model_type="logistic_regression"),
    }


def _config(root, ml, kind):
    gdmix_config = {
        "model_type": "detext" if kind == "detext" else "logistic_regression",
        "label_column_name": "response",
        "uid_column_name": "uid",
        "prediction_score_column_name": "predictionScore",
        "weight_column_name": "weight",
    }
    if kind == "detext":
        detext = os.path.join(ml, "detext")
        fe = {
            "training_data_dir": os.path.join(detext, "trainingData"),
            "validation_data_dir": os.path.join(detext, "validationData"),
            "metadata_file": os.path.join(detext, "metadata",
                                          "tensor_metadata.json"),
            "vocab_file": os.path.join(detext, "vocab.txt"),
            "feature_bag": "wide_ftrs_sp",
            "num_epochs": 5,
            "batch_size": 512,
            "num_units": 16,
            "num_filters": 8,
            "num_hidden": 16,
            "learning_rate": 0.02,
            "gdmix_config": gdmix_config,
        }
    else:
        fe = {
            "training_data_dir": os.path.join(ml, "global", "trainingData"),
            "validation_data_dir": os.path.join(ml, "global",
                                                "validationData"),
            "feature_file": os.path.join(ml, "global", "featureList",
                                         "global"),
            "feature_bag": "global",
            "metadata_file": os.path.join(ml, "global", "metadata",
                                          "tensor_metadata.json"),
            "l2_reg_weight": 1.0,
            "regularize_bias": False,
            "gdmix_config": gdmix_config,
        }
    return WorkflowConfig.from_dict({
        "output_dir": root,
        "fixed_effect_config": {"global": fe},
        "random_effect_config": {
            "per-user": _re_coord(ml, "per_user", "user_id", gdmix_config),
            "per-movie": _re_coord(ml, "per_movie", "movie_id", gdmix_config),
        },
    })


def main():
    kind = sys.argv[1] if len(sys.argv) > 1 else "lr"
    assert kind in ("lr", "detext"), kind
    tmp = tempfile.mkdtemp(prefix=f"time_{kind}_")
    data = movielens.generate_synthetic(num_users=USERS, num_movies=MOVIES,
                                        num_ratings=RATINGS, seed=7)
    t0 = time.perf_counter()
    ml = movielens.prepare_gdmix_data(tmp, data,
                                      with_detext=(kind == "detext"))
    prep_s = time.perf_counter() - t0
    out = {"kind": kind, "ratings": RATINGS, "prep_s": round(prep_s, 1),
           "devices": [str(d) for d in jax.devices()]}

    runs = {}
    for phase in ("cold", "warm"):
        root = os.path.join(tmp, f"run_{phase}")
        cfg = _config(root, ml, kind)
        t0 = time.perf_counter()
        metrics = run_gdmix_single_node(cfg)
        runs[phase] = round(time.perf_counter() - t0, 2)
        out[f"auc_{phase}"] = {k: round(v, 4) for k, v in metrics.items()}
    out["cold_s"] = runs["cold"]
    out["warm_s"] = runs["warm"]

    if kind == "lr":
        from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory
        mem = {}
        for phase in ("cold", "warm"):
            cfg = _config(os.path.join(tmp, f"mem_{phase}"), ml, kind)
            t0 = time.perf_counter()
            run_gdmix_in_memory(cfg)
            mem[phase] = round(time.perf_counter() - t0, 2)
        out["in_memory_cold_s"] = mem["cold"]
        out["in_memory_warm_s"] = mem["warm"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
