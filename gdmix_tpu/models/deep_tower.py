"""Deep fixed-effect tower: a DeText-style text ranker in flax.

The reference delegates deep fixed effects to the external DeText package
(/root/reference/gdmix-trainer/src/gdmix/models/detext/fixed_effect_detext_model.py,
arch per detext-movieLens.yaml: text CNN over doc_query + wide sparse features).
This is a JAX re-design with the same role in the pipeline: a
fixed-effect coordinate that consumes the DeText data layout (doc_query string +
wide_ftrs_sp bag + uid/weight/label) and emits the standard score interface
(predictionScore / predictionScorePerCoordinate avro) for downstream random
effects.

DeText breadth covered (--ftr_ext, doc fields, losses of the DeText package):
  * encoders: `cnn` (multi-window Conv1D + max-pool), `lstm` (masked
    recurrent encoder), `bert`/`transformer` (multi-head self-attention
    blocks trained from scratch — pretrained-BERT weights need egress this
    image doesn't have; the architecture and data path are the parity surface)
  * multi-field docs: `doc_text_columns` = comma list; shared embedding,
    per-field encoder, concatenated representations
  * losses: `classification` (pointwise weighted BCE, the gdmix-movieLens
    config) and `ranking` (in-batch pairwise logistic / RankNet within
    `query_column` groups — DeText's ranking objective family)

Training is mini-batch Adam (optax), data-parallel over the 1-D mesh via
sharded batches, with best-checkpoint selection on validation AUC exported as
a versioned orbax checkpoint (DeText's best-checkpoint export behavior).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

try:
    import flax.linen as nn
    import optax
except ImportError:  # pragma: no cover
    nn = None
    optax = None

from gdmix_tpu import constants
from gdmix_tpu.io import fs
from gdmix_tpu.io import scores as scores_io
from gdmix_tpu.io.input_pipeline import read_per_record
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.models.api import Model
from gdmix_tpu.ops.logistic import stable_bce
from gdmix_tpu.ops.metrics import auc as auc_metric
from gdmix_tpu.parallel.mesh import batch_sharding, get_mesh
from gdmix_tpu.params import Params, from_argv

logger = logging.getLogger(__name__)


@dataclass
class DeepTowerParams:
    """Hyperparameters, named after the DeText args used by the reference's
    detext-movieLens.yaml where they correspond."""
    metadata_file: str = ""
    output_model_dir: str = ""
    training_data_dir: Optional[str] = None
    validation_data_dir: Optional[str] = None
    feature_bag: Optional[str] = "wide_ftrs_sp"
    vocab_file: str = ""
    doc_text_column: str = "doc_query"
    doc_text_columns: Optional[str] = None  # comma list; overrides the single
    max_len: int = 16
    ftr_ext: str = "cnn"           # cnn | lstm | bert | transformer
    num_units: int = 64            # embedding dim
    filter_window_sizes: str = "1,2,3"
    num_filters: int = 50
    num_hidden: int = 100
    num_heads: int = 4             # transformer encoder
    num_layers: int = 2            # transformer/lstm encoder depth
    task_type: str = "classification"   # classification | ranking
    query_column: Optional[str] = None  # ranking group key (e.g. user_id)
    learning_rate: float = 0.002
    batch_size: int = 512
    num_epochs: int = 10
    l2_reg_weight: float = 0.0
    offset_column_name: str = "offset"
    dtype: str = "float32"
    seed: int = 0
    data_format: str = constants.TFRECORD

    def __post_init__(self):
        assert self.ftr_ext in ("cnn", "lstm", "bert", "transformer")
        assert self.task_type in ("classification", "ranking")
        if self.task_type == "ranking":
            assert self.query_column, "ranking needs a query_column to group by"

    @property
    def windows(self) -> List[int]:
        return [int(x) for x in str(self.filter_window_sizes).split(",")]

    @property
    def text_columns(self) -> List[str]:
        if self.doc_text_columns:
            return [c.strip() for c in str(self.doc_text_columns).split(",")]
        return [self.doc_text_column]


class _TextWideTower(nn.Module if nn else object):
    """Text encoder (cnn | lstm | transformer) + wide linear tower → MLP →
    logit. Multi-field docs share the embedding table; each field gets its own
    encoder parameters and the representations concatenate (DeText doc-field
    handling)."""
    vocab_size: int
    num_wide: int
    num_units: int
    windows: Tuple[int, ...]
    num_filters: int
    num_hidden: int
    ftr_ext: str = "cnn"
    num_heads: int = 4
    num_layers: int = 2

    def _encode_cnn(self, emb, mask):
        pooled = []
        for w in self.windows:
            conv = nn.Conv(self.num_filters, kernel_size=(w,),
                           padding="SAME")(emb)
            conv = nn.relu(conv)
            conv = jnp.where(mask[..., None] > 0, conv, -1e9)
            pooled.append(jnp.max(conv, axis=1))
        return jnp.concatenate(pooled, axis=-1)

    def _encode_lstm(self, emb, mask):
        x = emb
        for _ in range(self.num_layers):
            x = nn.RNN(nn.OptimizedLSTMCell(self.num_units))(x)
        x = jnp.where(mask[..., None] > 0, x, -1e9)
        return jnp.max(x, axis=1)  # masked max-pool over time

    def _encode_transformer(self, emb, mask):
        length = emb.shape[1]
        pos = self.param("posemb", nn.initializers.normal(0.02),
                         (1, length, self.num_units))
        x = emb + pos
        attn_mask = (mask[:, None, None, :] > 0)      # [B, 1, 1, L]
        for _ in range(self.num_layers):
            att = nn.SelfAttention(num_heads=self.num_heads)(x, mask=attn_mask)
            x = nn.LayerNorm()(x + att)
            ff = nn.Dense(self.num_units)(
                nn.relu(nn.Dense(4 * self.num_units)(x)))
            x = nn.LayerNorm()(x + ff)
        denom = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1.0)
        return jnp.sum(x * mask[..., None], axis=1) / denom  # masked mean

    @nn.compact
    def __call__(self, tokens, token_mask, wide_indices, wide_values):
        # tokens/token_mask: [B, F, L] — F doc fields with a SHARED embedding
        embed = nn.Embed(self.vocab_size, self.num_units,
                         embedding_init=nn.initializers.normal(0.1))
        encode = {"cnn": self._encode_cnn, "lstm": self._encode_lstm,
                  "bert": self._encode_transformer,
                  "transformer": self._encode_transformer}[self.ftr_ext]
        reprs = []
        for f in range(tokens.shape[1]):
            mask_f = token_mask[:, f]
            emb = embed(tokens[:, f]) * mask_f[..., None]
            reprs.append(encode(emb, mask_f))
        text_repr = jnp.concatenate(reprs, axis=-1)

        # wide tower: linear over the sparse bag
        wide_w = self.param("wide_w", nn.initializers.zeros, (self.num_wide,))
        wide_score = jnp.sum(jnp.take(wide_w, wide_indices, axis=0) * wide_values,
                             axis=-1, keepdims=True)

        h = jnp.concatenate([text_repr, wide_score], axis=-1)
        h = nn.relu(nn.Dense(self.num_hidden)(h))
        logit = nn.Dense(1)(h)
        return logit[..., 0] + wide_score[..., 0]


def pairwise_ranking_loss(logits, labels, weights, group_ids):
    """In-batch pairwise logistic (RankNet) loss over same-group pairs with
    label_i > label_j — the DeText ranking objective family. Group-less or
    single-label groups contribute nothing."""
    diff = logits[:, None] - logits[None, :]
    pair = ((labels[:, None] > labels[None, :])
            & (group_ids[:, None] == group_ids[None, :]))
    w = weights[:, None] * pair
    per = jnp.log1p(jnp.exp(-diff))
    return jnp.sum(w * per) / jnp.maximum(jnp.sum(w), 1.0)


def _load_vocab(vocab_file: str) -> Dict[str, int]:
    # fs seam: the vocab may live on a remote scheme, like DeText's vocab on
    # HDFS (reference detext-movieLens.yaml vocab_file + tf.io.gfile reads)
    with fs.open(vocab_file, encoding="utf-8") as f:
        return {line.strip(): i for i, line in enumerate(f) if line.strip()}


def _tokenize(texts, vocab: Dict[str, int], max_len: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    pad = vocab.get("[PAD]", 0)
    unk = vocab.get("[UNK]", 1)
    n = len(texts)
    tokens = np.full((n, max_len), pad, dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.float32)
    for i, t in enumerate(texts):
        if isinstance(t, bytes):
            t = t.decode("utf-8")
        words = str(t).split()[:max_len]
        for j, w in enumerate(words):
            tokens[i, j] = vocab.get(w, unk)
            mask[i, j] = 1.0
    return tokens, mask


class DeepTowerModel(Model):
    """Deep fixed-effect coordinate with the standard score interface."""

    def __init__(self, model_params: DeepTowerParams, base_params: Params):
        assert nn is not None and optax is not None, \
            "flax/optax are required for the deep tower"
        self.model_params = model_params
        self.base_params = base_params
        self.metadata_file = model_params.metadata_file
        self.checkpoint_path = model_params.output_model_dir
        self.training_data_dir = model_params.training_data_dir
        self.validation_data_dir = model_params.validation_data_dir
        self.metadata = DatasetMetadata.from_file(self.metadata_file)
        self.feature_bag = model_params.feature_bag
        self.num_wide = self.metadata.num_features(self.feature_bag)
        self.vocab = _load_vocab(model_params.vocab_file)
        self.dtype = jnp.dtype(model_params.dtype)
        self.module = _TextWideTower(
            vocab_size=len(self.vocab), num_wide=self.num_wide,
            num_units=model_params.num_units,
            windows=tuple(model_params.windows),
            num_filters=model_params.num_filters,
            num_hidden=model_params.num_hidden,
            ftr_ext=model_params.ftr_ext,
            num_heads=model_params.num_heads,
            num_layers=model_params.num_layers)
        self.params_tree = None
        self.mesh = get_mesh()
        ndev = len(self.mesh.devices.flatten())
        # data-parallel mini-batches when the batch divides the mesh
        self._shard_batches = model_params.batch_size % ndev == 0

    # ------------------------------------------------------------------ data --

    def _load_arrays(self, data_dir: str, schema_params):
        data = read_per_record(data_dir, self.metadata, self.feature_bag)
        p = self.model_params
        per_field = [_tokenize(data.columns[c], self.vocab, p.max_len)
                     for c in p.text_columns]
        tokens = np.stack([t for t, _ in per_field], axis=1)   # [n, F, L]
        mask = np.stack([m for _, m in per_field], axis=1)
        n = data.num_samples
        md = self.metadata
        labels = (data.column(schema_params.label_column_name).astype(np.float32)
                  if md.has_label(schema_params.label_column_name)
                  else np.zeros(n, np.float32))
        weights = (data.column(schema_params.weight_column_name).astype(np.float32)
                   if md.has_feature(schema_params.weight_column_name)
                   else np.ones(n, np.float32))
        # coordinate semantics: the offset may come from the dataset schema OR
        # be injected by the in-memory pipeline's score ledger — column
        # presence decides, exactly like the LR fixed effect
        offsets = (data.columns[p.offset_column_name].astype(np.float32)
                   if p.offset_column_name in data.columns
                   else np.zeros(n, np.float32))
        uid = data.column(schema_params.uid_column_name).astype(np.int64)
        if p.query_column and p.query_column in data.columns:
            qcol = data.columns[p.query_column]
            _, groups = np.unique(np.asarray([str(q) for q in qcol]),
                                  return_inverse=True)
            groups = groups.astype(np.int32)
        else:
            groups = np.zeros(n, np.int32)
        return dict(tokens=tokens, mask=mask, indices=data.indices,
                    values=data.values.astype(np.float32), labels=labels,
                    weights=weights, offsets=offsets, uid=uid, n=n,
                    groups=groups)

    # ----------------------------------------------------------------- train --

    def train(self, training_data_dir, validation_data_dir, metadata_file,
              checkpoint_path, execution_context, schema_params):
        p = self.model_params
        logger.info("Kicking off deep-tower training")
        train = self._load_arrays(training_data_dir, schema_params)
        valid = (self._load_arrays(validation_data_dir, schema_params)
                 if validation_data_dir else None)

        nproc = jax.process_count()
        ndev = len(self.mesh.devices.flatten())
        if nproc > 1 and p.batch_size % ndev != 0:
            raise ValueError(
                f"multi-host deep-tower training needs batch_size divisible "
                f"by the global device count ({p.batch_size} % {ndev})")

        rng = jax.random.PRNGKey(p.seed)
        sample = self._numpy_slice(train, np.arange(min(8, train["n"])))
        params = self.module.init(rng, *sample[:4])
        tx = optax.adam(p.learning_rate)
        opt_state = tx.init(params)

        ranking = p.task_type == "ranking"

        @jax.jit
        def train_step(params, opt_state, tokens, mask, indices, values,
                       labels, weights, offsets, groups):
            def loss_fn(prm):
                logits = self.module.apply(prm, tokens, mask, indices, values)
                if ranking:
                    data_loss = pairwise_ranking_loss(logits + offsets, labels,
                                                      weights, groups)
                else:
                    per = stable_bce(logits + offsets, labels)
                    data_loss = jnp.mean(weights * per)
                l2 = sum(jnp.sum(x ** 2) for x in jax.tree.leaves(prm))
                return data_loss + p.l2_reg_weight * l2
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        @jax.jit
        def score_fn(params, tokens, mask, indices, values):
            return self.module.apply(params, tokens, mask, indices, values)

        rng_np = np.random.RandomState(p.seed)
        n = train["n"]
        steps_per_epoch = max(1, n // p.batch_size)
        best_auc, best_params = -1.0, params
        for epoch in range(p.num_epochs):
            perm = rng_np.permutation(n)
            losses = []
            for s in range(steps_per_epoch):
                idx = perm[s * p.batch_size:(s + 1) * p.batch_size]
                if nproc > 1 and len(idx) % ndev != 0:
                    # degenerate n < batch_size tail: drop the remainder so
                    # the global batch stays evenly sharded (drop_remainder)
                    idx = idx[:len(idx) // ndev * ndev]
                    if len(idx) == 0:
                        continue
                batch = self._batch_slice(train, idx)
                params, opt_state, loss = train_step(params, opt_state, *batch)
                losses.append(float(loss))
            if valid is not None:
                vscores = self._score_all(score_fn, params, valid)
                vauc = float(auc_metric(vscores + valid["offsets"],
                                        valid["labels"]))
                logger.info("epoch %d loss %.5f val auc %.4f", epoch,
                            np.mean(losses), vauc)
                if vauc > best_auc:
                    best_auc, best_params = vauc, params
            else:
                best_params = params
        self.params_tree = best_params
        is_chief = execution_context.get(constants.IS_CHIEF, True)
        if nproc > 1:
            # orbax coordinates multi-host saves itself (primary writes the
            # data, everyone barriers) — a chief-only call would leave the
            # chief's barrier collectives unmatched and crash the runtime
            self._save_checkpoint(write_manifest=is_chief)
        elif is_chief:
            self._save_checkpoint()

        # Score train + validation with the best checkpoint. Multi-process:
        # every step above was one SPMD computation over the global mesh
        # (per-process sample shards, replicated params, all-reduced grads
        # — _batch_slice), so params are identical by construction; scoring
        # runs SPMD the same way and each process writes every
        # num_workers-th record, keeping the union of part files
        # duplicate-free.
        task_index = execution_context.get(constants.TASK_INDEX, 0)
        num_workers = execution_context.get(constants.NUM_WORKERS, 1)
        self._write_scores(score_fn, train, schema_params,
                           self.base_params.training_score_dir, task_index,
                           num_workers=num_workers)
        if valid is not None:
            self._write_scores(score_fn, valid, schema_params,
                               self.base_params.validation_score_dir, task_index,
                               num_workers=num_workers)

    @staticmethod
    def _numpy_slice(arrays, idx):
        return (arrays["tokens"][idx], arrays["mask"][idx],
                arrays["indices"][idx], arrays["values"][idx],
                arrays["labels"][idx], arrays["weights"][idx],
                arrays["offsets"][idx], arrays["groups"][idx])

    def _batch_slice(self, arrays, idx):
        """Device batch for one step. Multi-host: every process holds the
        full arrays and the SAME permutation (identical seed); each takes
        its contiguous slice of the global batch and the global sharded
        arrays assemble from the process-local pieces — per-process sample
        shards with replicated params, GSPMD all-reducing the grads exactly
        like the LR fixed effect (≡ DeText on TFJob worker replicas,
        reference container_ops.py:91-114, minus the parameter servers the
        SPMD design doesn't need)."""
        nproc = jax.process_count()
        ndev = len(self.mesh.devices.flatten())
        if nproc > 1:
            assert len(idx) % ndev == 0, (len(idx), ndev)
            per = len(idx) // nproc
            rank = jax.process_index()
            local = self._numpy_slice(arrays, idx[rank * per:(rank + 1) * per])
            return tuple(
                jax.make_array_from_process_local_data(
                    batch_sharding(self.mesh, rank=a.ndim), a)
                for a in local)
        batch = self._numpy_slice(arrays, idx)
        if self._shard_batches and len(idx) % ndev == 0:
            # batch dim sharded over the mesh; params stay replicated (XLA
            # all-reduces the grads — data-parallel SGD)
            batch = tuple(
                jax.device_put(a, batch_sharding(self.mesh, rank=a.ndim))
                for a in batch)
        return batch

    def _score_all(self, score_fn, params, arrays, chunk: int = 4096) -> np.ndarray:
        """Scores for ALL rows, identical on every process. Multi-host: each
        chunk is scored as one SPMD computation over the global mesh (every
        process participates — per-process divergent computations would
        deadlock the collectives), then the per-process contiguous shards
        allgather back to hosts."""
        nproc = jax.process_count()
        ndev = len(self.mesh.devices.flatten())
        out = []
        for s in range(0, arrays["n"], chunk):
            idx = np.arange(s, min(s + chunk, arrays["n"]))
            true_len = len(idx)
            if nproc > 1 and len(idx) % ndev != 0:
                pad = ndev - len(idx) % ndev
                idx = np.concatenate([idx, np.full(pad, idx[-1])])
            batch = self._batch_slice(arrays, idx)
            z = score_fn(params, *batch[:4])
            if nproc > 1:
                from jax.experimental import multihost_utils
                shards = sorted(z.addressable_shards,
                                key=lambda sh: sh.index[0].start or 0)
                local = np.concatenate([np.asarray(sh.data)
                                        for sh in shards])
                z = multihost_utils.process_allgather(local).reshape(-1)
            out.append(np.asarray(z)[:true_len])
        return np.concatenate(out) if out else np.zeros(0)

    def _write_scores(self, score_fn, arrays, schema_params, output_dir,
                      task_index, num_workers: int = 1):
        if not output_dir:
            return
        if num_workers > 1 and jax.process_count() == 1:
            # independent (non-jax-coordinated) worker replicas: slice THIS
            # worker's interleaved subset before scoring — no collectives to
            # keep in lockstep, and scoring everything would cost
            # num_workers x the work
            sub = np.arange(task_index, arrays["n"], num_workers)
            arrays = dict(arrays, n=len(sub),
                          **{k: arrays[k][sub]
                             for k in ("tokens", "mask", "indices", "values",
                                       "labels", "weights", "offsets", "uid",
                                       "groups")})
            keep = np.arange(arrays["n"])
        else:
            # jax-coordinated multi-host: score EVERYTHING once (one SPMD
            # computation — divergent per-process computations would
            # deadlock the collectives), then write only this worker's
            # interleaved slice; the union of part files is duplicate-free
            keep = np.arange(task_index, arrays["n"], num_workers) \
                if num_workers > 1 else np.arange(arrays["n"])
        per_coordinate = self._score_all(score_fn, self.params_tree, arrays)
        total = per_coordinate + arrays["offsets"]
        out = os.path.join(output_dir, f"part-{task_index:05d}.avro")
        scores_io.write_scores(out, schema_params, arrays["uid"][keep],
                               total[keep],
                               scores_per_coordinate=per_coordinate[keep],
                               labels=arrays["labels"][keep],
                               weights=arrays["weights"][keep])
        logger.info("Wrote %d deep-tower scores to %s", len(keep), out)

    # ------------------------------------------------------------ checkpoint --
    # Versioned orbax checkpoint (replaces DeText's TF checkpoints, reference
    # fixed_effect_detext_model.py:31,67-69): an orbax PyTree dir plus a
    # manifest recording format version + the hyperparameters the module was
    # built with, so a loader can validate compatibility before restore.

    CKPT_FORMAT_VERSION = 1

    def _ckpt_dir(self) -> str:
        # orbax needs absolute LOCAL paths; scheme paths pass through
        # untouched and are bridged below via write-local-then-upload
        path = self.checkpoint_path
        if fs.is_local(path):
            path = os.path.abspath(path)
        return os.path.join(path, "deep_tower_ckpt")

    def _save_checkpoint(self, write_manifest: bool = True) -> None:
        """Versioned orbax checkpoint + manifest. Remote checkpoint_path
        (scheme://): orbax writes a local temp dir which is then uploaded
        whole — the write half of copy-through-local at directory
        granularity (DeText's checkpoints land on the shared HDFS store the
        same way, reference fixed_effect_detext_model.py:43-89). Multi-host:
        EVERY process must call this (orbax barriers internally; the primary
        writes the data); only the chief passes write_manifest."""
        import orbax.checkpoint as ocp
        flat = jax.tree.map(lambda x: np.asarray(x), self.params_tree)
        ckptr = ocp.StandardCheckpointer()
        ckpt_dir = self._ckpt_dir()
        if fs.is_local(ckpt_dir):
            os.makedirs(self.checkpoint_path, exist_ok=True)
            ckptr.save(os.path.join(ckpt_dir, "params"), flat, force=True)
            ckptr.wait_until_finished()
        else:
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                local = os.path.join(tmp, "params")
                ckptr.save(local, flat, force=True)
                ckptr.wait_until_finished()
                if jax.process_index() == 0:
                    # only the primary's temp dir holds the written files
                    fs.upload_dir(local, ckpt_dir + "/params")
        if not write_manifest:
            return
        with fs.open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
            json.dump({"format_version": self.CKPT_FORMAT_VERSION,
                       "model": "deep_tower",
                       "vocab_size": len(self.vocab),
                       "num_wide": self.num_wide,
                       "hparams": dataclasses.asdict(self.model_params)}, f,
                      indent=2)
        logger.info("Saved deep-tower checkpoint to %s", ckpt_dir)

    def _load_checkpoint(self) -> None:
        import orbax.checkpoint as ocp
        with fs.open(os.path.join(self._ckpt_dir(), "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["format_version"] == self.CKPT_FORMAT_VERSION, \
            f"unsupported checkpoint version {manifest['format_version']}"
        assert manifest["vocab_size"] == len(self.vocab) \
            and manifest["num_wide"] == self.num_wide, \
            "checkpoint was trained with a different vocab/feature space"
        # restore against the module's own structure (safe topology check)
        rng = jax.random.PRNGKey(0)
        n_fields = len(self.model_params.text_columns)
        template = self.module.init(
            rng, np.zeros((1, n_fields, self.model_params.max_len), np.int32),
            np.zeros((1, n_fields, self.model_params.max_len), np.float32),
            np.zeros((1, 1), np.int32), np.zeros((1, 1), np.float32))
        template = jax.tree.map(lambda x: np.asarray(x), template)
        params_dir = os.path.join(self._ckpt_dir(), "params")
        if fs.is_local(params_dir):
            restored = ocp.StandardCheckpointer().restore(params_dir, template)
        else:
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                local = os.path.join(tmp, "params")
                fs.download_dir(params_dir, local)
                restored = ocp.StandardCheckpointer().restore(local, template)
        self.params_tree = jax.tree.map(jnp.asarray, restored)

    def export(self, output_model_dir):
        if self.params_tree is not None:
            self._save_checkpoint()

    # --------------------------------------------------------------- predict --

    def predict(self, output_dir, input_data_path, metadata_file, checkpoint_path,
                execution_context, schema_params):
        self._load_checkpoint()
        arrays = self._load_arrays(input_data_path, schema_params)

        @jax.jit
        def score_fn(params, tokens, mask, indices, values):
            return self.module.apply(params, tokens, mask, indices, values)

        task_index = execution_context.get(constants.TASK_INDEX, 0)
        num_workers = execution_context.get(constants.NUM_WORKERS, 1)
        self._write_scores(score_fn, arrays, schema_params, output_dir,
                           task_index, num_workers=num_workers)

    @staticmethod
    def from_argv(argv, base_params: Params) -> "DeepTowerModel":
        return DeepTowerModel(from_argv(DeepTowerParams, argv), base_params)
