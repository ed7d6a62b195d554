"""Deep-tower (DeText-equivalent) tests: learns planted text+wide signal, scores
through the standard interface, predict reloads the best checkpoint."""
import os

import numpy as np
import pytest

from gdmix_tpu import constants
from gdmix_tpu.data import movielens
from gdmix_tpu.io.scores import read_scores
from gdmix_tpu.models.deep_tower import DeepTowerModel, DeepTowerParams, _tokenize
from gdmix_tpu.ops.metrics import auc as auc_metric
from gdmix_tpu.params import Params


@pytest.fixture(scope="module")
def detext_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dml"))
    data = movielens.generate_synthetic(num_users=60, num_movies=80,
                                        num_ratings=4000, seed=11)
    ml_root = movielens.prepare_gdmix_data(root, data, with_detext=True)
    return os.path.join(ml_root, "detext")


def test_tokenizer():
    vocab = {"[PAD]": 0, "[UNK]": 1, "star": 2, "night": 3}
    tokens, mask = _tokenize([b"star night", "night wat", ""], vocab, 4)
    np.testing.assert_array_equal(tokens, [[2, 3, 0, 0], [3, 1, 0, 0],
                                           [0, 0, 0, 0]])
    np.testing.assert_array_equal(mask, [[1, 1, 0, 0], [1, 1, 0, 0],
                                         [0, 0, 0, 0]])


def _build(detext_data, out_root, **over):
    for d in ("train_scores", "validation_scores", "models"):
        os.makedirs(os.path.join(out_root, d), exist_ok=True)
    base = Params(action="train", stage="fixed_effect", model_type="detext",
                  label_column_name="response", uid_column_name="uid",
                  weight_column_name="weight",
                  prediction_score_column_name="predictionScore",
                  training_score_dir=os.path.join(out_root, "train_scores"),
                  validation_score_dir=os.path.join(out_root,
                                                    "validation_scores"))
    kwargs = dict(
        metadata_file=os.path.join(detext_data, "metadata",
                                   "tensor_metadata.json"),
        output_model_dir=os.path.join(out_root, "models"),
        training_data_dir=os.path.join(detext_data, "trainingData"),
        validation_data_dir=os.path.join(detext_data, "validationData"),
        vocab_file=os.path.join(detext_data, "vocab.txt"),
        num_epochs=5, batch_size=256, num_units=16, num_filters=8,
        num_hidden=16, learning_rate=0.02)
    kwargs.update(over)
    return DeepTowerModel(DeepTowerParams(**kwargs), base), base


def test_train_score_predict(detext_data, tmp_path):
    out_root = str(tmp_path / "out")
    model, base = _build(detext_data, out_root)
    ctx = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
           constants.IS_CHIEF: True}
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, ctx, base)

    # validation scores beat chance comfortably (planted wide+latent signal)
    got = read_scores(base.validation_score_dir, base)
    vauc = float(auc_metric(got["predictionScore"], got["response"]))
    assert vauc > 0.6, f"validation AUC {vauc}"
    assert "predictionScorePerCoordinate" in got
    # versioned orbax checkpoint: params dir + manifest with format version
    ckpt = os.path.join(out_root, "models", "deep_tower_ckpt")
    assert os.path.isdir(os.path.join(ckpt, "params"))
    import json as _json
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = _json.load(f)
    assert manifest["format_version"] == 1 and manifest["model"] == "deep_tower"

    # cold predict from the checkpoint reproduces training-time scoring
    model2, base2 = _build(detext_data, out_root)
    pred_dir = str(tmp_path / "pred")
    model2.predict(pred_dir, model.validation_data_dir, model.metadata_file,
                   model.checkpoint_path, ctx, base)
    cold = read_scores(pred_dir, base)
    ow, oc = np.argsort(got["uid"]), np.argsort(cold["uid"])
    np.testing.assert_allclose(got["predictionScore"][ow],
                               cold["predictionScore"][oc], atol=1e-4)


# --- DeText breadth: encoders / ranking loss / multi-field docs ----------------

def _train_and_auc(detext_data, tmp_path, **over):
    out_root = str(tmp_path / "out")
    model, base = _build(detext_data, out_root, **over)
    ctx = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
           constants.IS_CHIEF: True}
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, ctx, base)
    got = read_scores(base.validation_score_dir, base)
    return model, base, float(auc_metric(got["predictionScore"],
                                         got["response"]))


def test_lstm_encoder_learns(detext_data, tmp_path):
    _, _, vauc = _train_and_auc(detext_data, tmp_path, ftr_ext="lstm",
                                num_epochs=3, num_layers=1)
    assert vauc > 0.55, vauc


def test_transformer_encoder_learns(detext_data, tmp_path):
    _, _, vauc = _train_and_auc(detext_data, tmp_path, ftr_ext="bert",
                                num_epochs=3, num_layers=1, num_heads=2)
    assert vauc > 0.55, vauc


def test_ranking_loss_learns(detext_data, tmp_path):
    """Pairwise in-batch ranking grouped by user: planted signal still ranks
    positives above negatives overall."""
    _, _, vauc = _train_and_auc(detext_data, tmp_path, task_type="ranking",
                                query_column="user_id", num_epochs=4)
    assert vauc > 0.55, vauc


def test_multi_field_docs_train_and_predict(detext_data, tmp_path):
    """Two doc fields (shared embedding, per-field encoders) incl. checkpoint
    round trip through the F=2 restore template."""
    out_root = str(tmp_path / "out")
    model, base = _build(detext_data, out_root,
                         doc_text_columns="doc_query,doc_query",
                         num_epochs=2)
    ctx = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
           constants.IS_CHIEF: True}
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, ctx, base)
    warm = read_scores(base.validation_score_dir, base)

    cold_model, _ = _build(detext_data, out_root,
                           doc_text_columns="doc_query,doc_query")
    pred_dir = os.path.join(out_root, "pred")
    cold_model.predict(pred_dir, cold_model.validation_data_dir,
                       cold_model.metadata_file, cold_model.checkpoint_path,
                       ctx, base)
    cold = read_scores(pred_dir, base)
    order_w, order_c = np.argsort(warm["uid"]), np.argsort(cold["uid"])
    np.testing.assert_allclose(
        np.asarray(warm["predictionScore"])[order_w],
        np.asarray(cold["predictionScore"])[order_c], atol=1e-5)


def test_pairwise_ranking_loss_math():
    from gdmix_tpu.models.deep_tower import pairwise_ranking_loss
    import jax.numpy as jnp
    logits = jnp.array([2.0, 0.0, 1.0, -1.0])
    labels = jnp.array([1.0, 0.0, 1.0, 0.0])
    weights = jnp.ones(4)
    # two groups: (0,1) and (2,3); pairs: (0>1) and (2>3)
    gid = jnp.array([0, 0, 1, 1])
    got = float(pairwise_ranking_loss(logits, labels, weights, gid))
    expected = np.mean([np.log1p(np.exp(-2.0)), np.log1p(np.exp(-2.0))])
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    # one global group: pairs (0>1),(0>3),(2>1),(2>3)
    gid1 = jnp.zeros(4, jnp.int32)
    got1 = float(pairwise_ranking_loss(logits, labels, weights, gid1))
    expected1 = np.mean([np.log1p(np.exp(-d)) for d in (2.0, 3.0, 1.0, 2.0)])
    np.testing.assert_allclose(got1, expected1, rtol=1e-6)


def test_multi_worker_sharded_scoring(detext_data, tmp_path):
    """With NUM_WORKERS=2 (simulated), the two workers' score files partition
    the rows exactly (no duplicates — the reference duplicates none either) and
    match the single-worker scores row-for-row (training is lockstep-replicated,
    so params are identical across workers)."""
    # single-worker oracle
    out1 = str(tmp_path / "one")
    model, base = _build(detext_data, out1)
    ctx1 = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
            constants.IS_CHIEF: True}
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, ctx1, base)
    ref = read_scores(base.validation_score_dir, base)

    # two simulated workers share one output dir (distinct part files)
    out2 = str(tmp_path / "two")
    got = {}
    for task in (0, 1):
        m, b = _build(detext_data, out2)
        ctx = {constants.TASK_INDEX: task, constants.NUM_WORKERS: 2,
               constants.IS_CHIEF: task == 0}
        m.train(m.training_data_dir, m.validation_data_dir, m.metadata_file,
                m.checkpoint_path, ctx, b)
        got[task] = b
    merged = read_scores(got[0].validation_score_dir, got[0])
    # exact partition: union of uids == single-worker uids, no duplicates
    assert len(merged["uid"]) == len(ref["uid"])
    assert len(np.unique(merged["uid"])) == len(merged["uid"])
    ow, om = np.argsort(ref["uid"]), np.argsort(merged["uid"])
    np.testing.assert_array_equal(ref["uid"][ow], merged["uid"][om])
    np.testing.assert_allclose(ref["predictionScore"][ow],
                               merged["predictionScore"][om], atol=1e-4)


def test_two_process_training_matches_single(detext_data, tmp_path):
    """REAL two-process SPMD deep-tower training (2 procs x 2 virtual devices):
    per-process batch shards + all-reduced grads must reproduce the
    single-process run — the JAX re-design of DeText on TFJob worker
    replicas (reference container_ops.py:91-114)."""
    import json
    import subprocess
    import sys

    single_root = str(tmp_path / "single")
    model, base = _build(detext_data, single_root, num_epochs=3,
                         batch_size=256)
    ctx = {constants.TASK_INDEX: 0, constants.NUM_WORKERS: 1,
           constants.IS_CHIEF: True}
    model.train(model.training_data_dir, model.validation_data_dir,
                model.metadata_file, model.checkpoint_path, ctx, base)
    single = read_scores(os.path.join(single_root, "validation_scores"), base)

    mp_root = str(tmp_path / "mp")
    runner = os.path.join(os.path.dirname(__file__),
                          "multiproc_deep_tower_runner.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, runner, str(pid), "2", detext_data, mp_root, "9936"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"proc {pid} failed:\n{outs[pid][-4000:]}"

    # union of the two interleaved part files = every validation record once
    mp = read_scores(os.path.join(mp_root, "validation_scores"), base)
    assert len(mp["uid"]) == len(single["uid"])
    assert len(np.unique(mp["uid"])) == len(np.unique(single["uid"]))
    om, os_ = np.argsort(mp["uid"], kind="stable"), \
        np.argsort(single["uid"], kind="stable")
    # different mesh/summation orders + Adam accumulation → close, not
    # bitwise; the learned ranking must agree
    a = mp["predictionScore"][om]
    b = single["predictionScore"][os_]
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.98, corr
    auc_mp = float(auc_metric(mp["predictionScore"], mp["response"]))
    auc_single = float(auc_metric(single["predictionScore"],
                                  single["response"]))
    assert abs(auc_mp - auc_single) < 0.05, (auc_mp, auc_single)
