"""In-memory coordinate-descent pipeline: NO file I/O between coordinates.

This is the device-resident fast path the reference architecture can't offer: where
GDMix writes scores/partitions/offsets to HDFS between every stage (SURVEY.md §1
"every layer boundary is file I/O"), here the uid-keyed score ledger lives in
memory, the offset update (OffsetUpdater semantics) is a vectorized join, entity
grouping is an in-process sort, and each coordinate's solver consumes the
previous coordinate's scores directly. Supports multiple coordinate-descent
sweeps: from sweep 2 on, offset = accumulated − own-previous-score
(/root/reference/gdmix-data/src/main/scala/com/linkedin/gdmix/data/
OffsetUpdater.scala:105-129).

Final artifacts (photon-ml avro models, evalSummary.json) are still written, so
the output stays drop-in compatible with the file-based workflow.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from gdmix_tpu import constants
from gdmix_tpu.data.evaluator import EVAL_SUMMARY_JSON
from gdmix_tpu.data.partitioner import PartitionerConfig, assign_group_ids, \
    group_by_entity
from gdmix_tpu.io.input_pipeline import PerRecordData, read_per_record
from gdmix_tpu.io.metadata import DatasetMetadata
from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel
from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel
from gdmix_tpu.ops.metrics import auc as auc_metric
from gdmix_tpu.params import FixedLRParams, Params, REParams, from_dict
from gdmix_tpu.workflow.config import METRIC, MODELS, WorkflowConfig
from gdmix_tpu.io import fs

logger = logging.getLogger(__name__)


@dataclass
class _Ledger:
    """uid-keyed accumulated scores + per-coordinate contributions."""
    uids: np.ndarray                      # sorted
    total: np.ndarray                     # accumulated score per uid
    per_coordinate: Dict[str, np.ndarray] = field(default_factory=dict)

    @classmethod
    def empty(cls, uids: np.ndarray) -> "_Ledger":
        order = np.argsort(uids)
        return cls(uids=uids[order], total=np.zeros(len(uids)))

    def lookup(self, uids: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self.uids, uids)
        assert np.array_equal(self.uids[pos], uids), "ledger missing uids"
        return self.total[pos]

    def apply_coordinate(self, name: str, uids: np.ndarray,
                         per_coordinate: np.ndarray) -> None:
        """total += new_contribution − previous contribution of this coordinate."""
        pos = np.searchsorted(self.uids, uids)
        assert np.array_equal(self.uids[pos], uids)
        delta = np.zeros_like(self.total)
        delta[pos] = per_coordinate
        prev = self.per_coordinate.get(name)
        if prev is not None:
            delta_prev = prev
        else:
            delta_prev = np.zeros_like(self.total)
        self.total = self.total + delta - delta_prev
        full = np.zeros_like(self.total)
        full[pos] = per_coordinate
        self.per_coordinate[name] = full


class InMemoryPipeline:
    """Runs fixed effect + random effects with the score ledger in memory.

    re_mode selects the random-effect training plane:
      * "host":    group entities on host (numpy) and solve vmapped buckets
      * "sharded": route records to entity-owner shards over the device
                   interconnect and group on device
                   (parallel/entity_sharding) — the multi-chip path
      * "auto":    the default — "sharded" iff the feature bag is
                   rectangular AND the (process-local) mesh has >1 device;
                   on a single device there is nothing to route, so auto
                   keeps "host" there (same rule as
                   RandomEffectLRModel.fit_flat)

    Under multi-process the two parallelism levels COMPOSE (≡ the reference's
    partitions-across-workers × pool-within-worker,
    random_effect_lr_lbfgs_model.py:82-217): entities are round-robin OWNED
    per process and exchanged as model files, while each process routes/
    groups/solves its own entities over its process-LOCAL device mesh.
    """

    def __init__(self, config: WorkflowConfig, num_sweeps: int = 1,
                 re_mode: str = "auto"):
        assert re_mode in ("host", "sharded", "auto")
        self.config = config
        self.num_sweeps = num_sweeps
        self.re_mode = re_mode
        self.metrics: Dict[str, float] = {}
        # validation AUC per coordinate after each sweep (`metrics` holds the
        # last); from sweep 2 on every coordinate trains against the others'
        # newest scores, so the ladder between coordinates flattens
        self.sweep_metrics: List[Dict[str, float]] = []

    def _use_sharded_re(self, data: PerRecordData) -> bool:
        if self.re_mode == "auto":
            # same auto semantics as RandomEffectLRModel.fit_flat and
            # docs/CONFIG.md: the device plane needs a rectangular padded bag
            # (intercept-only coordinates — indices None — keep the host
            # grouping) AND a >1-device mesh: with a single device there is
            # nothing to route
            import jax
            from gdmix_tpu.parallel.mesh import get_mesh, local_mesh
            mesh = get_mesh() if jax.process_count() == 1 else local_mesh()
            return (data.indices is not None
                    and len(mesh.devices.flatten()) > 1)
        return self.re_mode == "sharded"

    @staticmethod
    def _exchange_re_models(model_dir: str, sweep: int, name: str, partial,
                            model) -> Dict:
        """Multi-host model merge: each process owns a disjoint entity subset
        (round-robin ≡ random_effect_driver.py:60-68 partition assignment),
        writes its partial avro, barriers, and reads everyone's — the
        reference's partition-model-files contract, with the filesystem as the
        exchange fabric."""
        import jax
        if jax.process_count() == 1:
            return partial
        from jax.experimental import multihost_utils
        ex_dir = os.path.join(model_dir, f".exchange-sweep{sweep}")
        fs.makedirs(ex_dir, exist_ok=True)
        mine = os.path.join(ex_dir, f"part-{jax.process_index():05d}.avro")
        model._save_model(mine, partial)
        multihost_utils.sync_global_devices(f"re-models-{name}-{sweep}")
        merged: Dict = {}
        for f in sorted(fs.listdir(ex_dir)):
            if f.endswith(".avro"):
                merged.update(model._load_weights(os.path.join(ex_dir, f)))
        return merged

    def run(self) -> Dict[str, float]:
        cfg = self.config
        (fe_name, fe_raw), = cfg.fixed_effect_config.items()
        fe_config = dict(fe_raw)
        fe_gdmix = dict(fe_config.pop("gdmix_config"))
        fe_params = from_dict(Params, {**fe_gdmix, "stage": constants.FIXED_EFFECT})

        fe_model_params = from_dict(FixedLRParams, {
            **fe_config,
            "output_model_dir": os.path.join(cfg.output_dir, fe_name, MODELS)})
        fe_model = FixedEffectLRModel(fe_model_params, fe_params)

        # Load every coordinate's data once.
        fe_train = read_per_record(fe_config["training_data_dir"], fe_model.metadata,
                                   fe_model.feature_bag_name)
        fe_valid = read_per_record(fe_config["validation_data_dir"],
                                   fe_model.metadata, fe_model.feature_bag_name) \
            if fe_config.get("validation_data_dir") else None

        uid_col = fe_params.uid_column_name
        train_ledger = _Ledger.empty(fe_train.columns[uid_col].astype(np.int64))
        valid_ledger = (_Ledger.empty(fe_valid.columns[uid_col].astype(np.int64))
                        if fe_valid is not None else None)

        re_items = []
        for name, re_raw in cfg.random_effect_config.items():
            re_config = dict(re_raw)
            re_gdmix = dict(re_config.pop("gdmix_config"))
            re_config.pop("num_partitions", None)
            min_samples = re_config.pop("min_samples", None)
            max_samples = re_config.pop("max_samples", None)
            if re_gdmix.get("model_type", constants.LOGISTIC_REGRESSION) \
                    != constants.LOGISTIC_REGRESSION:
                # reference restriction (model_factory.py:46-47): random
                # effects are logistic-only
                raise ValueError(f"random effect {name}: only "
                                 f"{constants.LOGISTIC_REGRESSION} is "
                                 f"supported")
            re_params = from_dict(Params, {**re_gdmix,
                                           "stage": constants.RANDOM_EFFECT})
            re_model_params = from_dict(REParams, {
                **re_config,
                "output_model_dir": os.path.join(cfg.output_dir, name, MODELS)})
            model = RandomEffectLRModel(re_model_params, re_params)
            train = read_per_record(re_config["training_data_dir"], model.metadata,
                                    model.feature_bag_name)
            valid = read_per_record(re_config["validation_data_dir"],
                                    model.metadata, model.feature_bag_name) \
                if re_config.get("validation_data_dir") else None
            re_items.append(dict(name=name, model=model, params=re_params,
                                 train=train, valid=valid,
                                 min_samples=min_samples,
                                 max_samples=max_samples, weights={}))

        import jax
        nproc = jax.process_count()
        rank = jax.process_index()

        # multi-sweep device-array reuse: only the offset
        # column changes between sweeps (see _device_batch). Single-process,
        # fe_fit_view IS fe_train (same uids), so fit and train-scoring
        # share ONE cache and one HBM-resident copy of the static columns
        # serves both; multi-host they differ (the fit view is this
        # process's sample shard) and each gets its own cache — statics
        # still cross the link exactly once per view.
        fe_caches = {"fit": {}, "valid": {}}
        fe_caches["score_train"] = fe_caches["fit"] if nproc == 1 else {}
        for sweep in range(self.num_sweeps):
            logger.info("=== coordinate-descent sweep %d ===", sweep + 1)
            # ---- fixed effect ----
            self._set_offsets(fe_train, train_ledger, fe_name,
                              fe_model_params.offset_column_name,
                              uid_col)
            warm = fe_model.model_coefficients if sweep else None
            if nproc > 1:
                # every process holds the full in-HBM dataset; FE trains on
                # its sample shard (SPMD all-reduce keeps replicas identical)
                from gdmix_tpu.io.input_pipeline import slice_rows
                fe_fit_view = slice_rows(
                    fe_train, np.arange(rank, fe_train.num_samples, nproc))
            else:
                fe_fit_view = fe_train
            fe_model.fit_data(fe_fit_view, fe_params, warm_start=warm,
                              device_cache=fe_caches["fit"])
            tr_scores = fe_model.score_data(
                fe_train, fe_params, device_cache=fe_caches["score_train"])
            train_ledger.apply_coordinate(fe_name, tr_scores["uid"],
                                          tr_scores["per_coordinate"])
            if fe_valid is not None:
                self._set_offsets(fe_valid, valid_ledger, fe_name,
                                  fe_model_params.offset_column_name, uid_col)
                va = fe_model.score_data(fe_valid, fe_params,
                                         device_cache=fe_caches["valid"])
                valid_ledger.apply_coordinate(fe_name, va["uid"],
                                              va["per_coordinate"])
                self.metrics[fe_name] = float(auc_metric(
                    valid_ledger.total, self._labels(fe_valid, fe_params)))

            # ---- random effects ----
            for item in re_items:
                model: RandomEffectLRModel = item["model"]
                params: Params = item["params"]
                mp: REParams = model.model_params
                name = item["name"]

                self._set_offsets(item["train"], train_ledger, name,
                                  mp.offset_column_name,
                                  params.uid_column_name)
                pcfg = PartitionerConfig(
                    partition_entity=mp.partition_entity, num_partitions=1,
                    min_samples=item["min_samples"],
                    max_samples=item["max_samples"],
                    uid_column_name=params.uid_column_name,
                    offset_column_name=mp.offset_column_name)
                if self._use_sharded_re(item["train"]):
                    active = self._active_records(item["train"], pcfg)
                    if nproc > 1:
                        # two composed levels: round-robin entity OWNERSHIP
                        # across processes (model-file exchange), interconnect routing
                        # within each process's local mesh
                        from gdmix_tpu.data.partitioner import \
                            factorize_entities
                        from gdmix_tpu.io.input_pipeline import slice_rows
                        from gdmix_tpu.parallel.mesh import local_mesh
                        uniq, inv = factorize_entities(
                            active.columns[mp.partition_entity])
                        owned = (np.arange(len(uniq)) % nproc) == rank
                        partial = model.fit_records_sharded(
                            slice_rows(active, np.flatnonzero(owned[inv])),
                            params, model_weights=item["weights"],
                            mesh=local_mesh(),
                            device_cache=item.setdefault("dev_cache", {}))
                        partial = {eid: partial[eid] for eid in uniq[owned]}
                        merged = self._exchange_re_models(
                            os.path.join(cfg.output_dir, name, MODELS),
                            sweep, name, partial, model)
                        item["weights"] = dict(item["weights"], **merged)
                    else:
                        item["weights"] = model.fit_records_sharded(
                            active, params, model_weights=item["weights"],
                            device_cache=item.setdefault("dev_cache", {}))
                else:
                    groups = self._group(item["train"], pcfg, model.metadata,
                                         active_only=True)
                    if nproc > 1:
                        # round-robin entity ownership over the (identical)
                        # full entity list; merge via model-file exchange
                        from gdmix_tpu.data.bucketing import select_entities
                        owned = select_entities(
                            groups, np.arange(rank, len(groups), nproc))
                        partial = model.fit_groups(
                            owned, item["weights"], params,
                            device_cache=item.setdefault("dev_cache", {}))
                        partial = {eid: partial[eid]
                                   for eid in owned.entity_ids}
                        merged = self._exchange_re_models(
                            os.path.join(cfg.output_dir, name, MODELS),
                            sweep, name, partial, model)
                        item["weights"] = dict(item["weights"], **merged)
                    else:
                        # device_cache: sweep 2+ re-ships only offsets/theta0
                        # — the records are identical between sweeps (the
                        # ledger mutates only the offset column)
                        item["weights"] = model.fit_groups(
                            groups, item["weights"], params,
                            device_cache=item.setdefault("dev_cache", {}))

                # score ALL training rows (active + passive) for the ledger —
                # O(nnz) sparse-CSR record scoring, no re-grouping needed
                sc = model.score_records(item["train"], item["weights"], params)
                train_ledger.apply_coordinate(name, sc["uid"],
                                              sc["per_coordinate"])

                if item["valid"] is not None:
                    self._set_offsets(item["valid"], valid_ledger, name,
                                      mp.offset_column_name,
                                      params.uid_column_name)
                    vs = model.score_records(item["valid"], item["weights"],
                                             params)
                    valid_ledger.apply_coordinate(name, vs["uid"],
                                                  vs["per_coordinate"])
                    self.metrics[name] = float(auc_metric(
                        valid_ledger.total,
                        self._labels(item["valid"], params)))
            self.sweep_metrics.append(dict(self.metrics))

        # ---- persist final artifacts (chief only under multi-host) ----
        if rank == 0:
            fs.makedirs(os.path.join(cfg.output_dir, fe_name, MODELS),
                        exist_ok=True)
            fe_model._save_model()
            self._write_metric(fe_name)
            for item in re_items:
                model_dir = os.path.join(cfg.output_dir, item["name"], MODELS)
                fs.makedirs(model_dir, exist_ok=True)
                item["model"]._save_model(
                    os.path.join(model_dir, "part-00000.avro"), item["weights"])
                self._write_metric(item["name"])
        return dict(self.metrics)

    # ------------------------------------------------------------------ utils --

    @staticmethod
    def _labels(data: PerRecordData, params: Params) -> np.ndarray:
        return data.columns[params.label_column_name].astype(np.float64)

    @staticmethod
    def _set_offsets(data: PerRecordData, ledger: Optional[_Ledger],
                     coordinate_name: str, offset_column: str,
                     uid_column: str = "uid") -> None:
        """offset = accumulated − own contribution (OffsetUpdater semantics;
        the own-term is zero on the first sweep)."""
        if ledger is None:
            return
        uids = data.columns[uid_column].astype(np.int64)
        pos = np.searchsorted(ledger.uids, uids)
        total = ledger.total[pos]
        own = ledger.per_coordinate.get(coordinate_name)
        if own is not None:
            total = total - own[pos]
        data.columns[offset_column] = total.astype(np.float32)

    @staticmethod
    def _active_records(data: PerRecordData, pcfg: PartitionerConfig
                        ) -> PerRecordData:
        """Active-only record view for the sharded RE path (group id 0 —
        DataPartitioner's min/max bounding, getGroupId :332-379)."""
        if not (pcfg.min_samples or pcfg.max_samples):
            return data
        from gdmix_tpu.io.input_pipeline import slice_rows
        uids = data.columns[pcfg.uid_column_name].astype(np.int64)
        gids = assign_group_ids(
            np.asarray(data.columns[pcfg.partition_entity]), uids,
            pcfg.min_samples, pcfg.max_samples)
        return slice_rows(data, np.flatnonzero(gids == 0))

    @staticmethod
    def _group(data: PerRecordData, pcfg: PartitionerConfig,
               metadata: DatasetMetadata, active_only: bool):
        uids = data.columns[pcfg.uid_column_name].astype(np.int64)
        if active_only and (pcfg.min_samples or pcfg.max_samples):
            gids = assign_group_ids(
                np.asarray(data.columns[pcfg.partition_entity]), uids,
                pcfg.min_samples, pcfg.max_samples)
        else:
            gids = np.zeros(len(uids), dtype=np.int64)
        if active_only:
            # columnar path: no per-entity objects on the training hot path
            from gdmix_tpu.data.partitioner import group_flat
            return group_flat(data, pcfg, gids, active_only=True)
        # merge one entity's groups back together for scoring
        grouped = group_by_entity(data, pcfg, metadata, gids)
        return [g for _, _, g in grouped]

    def _write_metric(self, name: str) -> None:
        if name not in self.metrics:
            return
        d = os.path.join(self.config.output_dir, name, METRIC)
        fs.makedirs(d, exist_ok=True)
        with fs.open(os.path.join(d, EVAL_SUMMARY_JSON), "w") as f:
            json.dump({"auc": self.metrics[name]}, f)


def run_gdmix_in_memory(config_path_or_obj, num_sweeps: int = 1,
                        re_mode: Optional[str] = None) -> Dict[str, float]:
    """re_mode precedence: explicit argument > the config's top-level
    `re_mode` key > "auto" (the sharded multi-chip plane whenever the
    feature bag is rectangular)."""
    config = (config_path_or_obj if isinstance(config_path_or_obj, WorkflowConfig)
              else WorkflowConfig.from_file(config_path_or_obj))
    if re_mode is None:
        re_mode = config.extras.get("re_mode", "auto")
    return InMemoryPipeline(config, num_sweeps=num_sweeps,
                            re_mode=re_mode).run()
