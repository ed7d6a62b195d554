"""Parameter dataclasses + CLI flag parsing.

Mirrors the reference's smart-arg dataclasses (/root/reference/gdmix-trainer/src/
gdmix/params.py, models/custom/base_lr_params.py, FixedLRParams, REParams) so the
same flag vocabulary drives this trainer. Unknown argv entries are ignored, letting
one argv serve Params + model params (reference gdmix.py:21-22).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Type, TypeVar

from gdmix_tpu import constants

_ACTIONS = (constants.ACTION_INFERENCE, constants.ACTION_TRAIN)
_STAGES = (constants.FIXED_EFFECT, constants.RANDOM_EFFECT)
_MODEL_TYPES = (constants.LOGISTIC_REGRESSION, constants.LINEAR_REGRESSION,
                constants.DETEXT)
_VARIANCE_MODES = (constants.FULL, constants.SIMPLE)
# fixed-effect gradient strategies (FixedEffectLRModel._objective_fun)
GRAD_MODES = ("auto", "block", "onehot", "scatter", "segment", "hybrid")

T = TypeVar("T")


def _coerce(value: str, typ):
    if typ is bool:
        return value.lower() in ("true", "1", "yes")
    origin = getattr(typ, "__origin__", None)
    if origin is not None:  # Optional[X] / List[X]
        args = [a for a in typ.__args__ if a is not type(None)]
        if origin is list:
            return [_coerce(v, args[0]) for v in value.split(",")]
        return _coerce(value, args[0])
    return typ(value)


def from_argv(cls: Type[T], argv: List[str], error_on_unknown: bool = False) -> T:
    """Parse --key=value / --key value flags into a dataclass, ignoring unknowns."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            i += 1
            continue
        if "=" in tok:
            key, value = tok[2:].split("=", 1)
            i += 1
        else:
            key = tok[2:]
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                value = argv[i + 1]
                i += 2
            else:
                value = "true"
                i += 1
        key = key.replace("-", "_")
        f = fields.get(key)
        if f is None:
            if error_on_unknown:
                raise ValueError(f"Unknown flag --{key}")
            continue
        kwargs[key] = _coerce(value, f.type if not isinstance(f.type, str)
                              else _resolve_type(cls, f.name))
    return cls(**kwargs)


def _resolve_type(cls, name):
    import typing
    hints = typing.get_type_hints(cls)
    return hints[name]


def from_dict(cls: Type[T], d: dict, error_on_unknown: bool = False) -> T:
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k.replace("-", "_"): v for k, v in d.items()
              if k.replace("-", "_") in fields}
    if error_on_unknown:
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"Unknown config keys {unknown}")
    return cls(**kwargs)


@dataclass
class SchemaParams:
    """Dataset schema column names (reference params.py:35-43)."""
    uid_column_name: str = "uid"
    weight_column_name: Optional[str] = None
    label_column_name: Optional[str] = None
    prediction_score_column_name: Optional[str] = None
    prediction_score_per_coordinate_column_name: str = "predictionScorePerCoordinate"


@dataclass
class Params(SchemaParams):
    """Top-level driver params (reference params.py:12-55)."""
    action: str = constants.ACTION_TRAIN
    stage: str = constants.FIXED_EFFECT
    model_type: str = constants.LOGISTIC_REGRESSION
    training_score_dir: Optional[str] = None
    validation_score_dir: Optional[str] = None
    partition_list_file: Optional[str] = None

    def __post_init__(self):
        assert self.action in _ACTIONS, f"Action: {self.action} must be in {_ACTIONS}"
        assert self.stage in _STAGES, f"Stage: {self.stage} must be in {_STAGES}"
        assert self.model_type in _MODEL_TYPES, \
            f"Model type: {self.model_type} must be in {_MODEL_TYPES}"
        assert (self.action == constants.ACTION_TRAIN and self.label_column_name) or \
               (self.action == constants.ACTION_INFERENCE
                and self.prediction_score_column_name)


@dataclass
class LRParams:
    """Shared linear-model hyperparams (reference base_lr_params.py)."""
    metadata_file: str = ""
    output_model_dir: str = ""
    training_data_dir: Optional[str] = None
    validation_data_dir: Optional[str] = None
    feature_bag: Optional[str] = None
    feature_file: Optional[str] = None
    regularize_bias: bool = True
    l2_reg_weight: float = 1.0
    lbfgs_tolerance: float = 1e-12
    lbfgs_pgtol: float = 1e-5       # ‖proj g‖∞ stop (scipy fmin_l_bfgs_b default)
    num_of_lbfgs_curvature_pairs: int = 10
    num_of_lbfgs_iterations: int = 100
    has_intercept: bool = True
    offset_column_name: str = "offset"
    sparsity_threshold: float = 1.0e-4
    batch_size: int = 16
    data_format: str = constants.TFRECORD
    # pluggable dataset hook: "package.module.fn" called as
    # fn(input_path, metadata, feature_bag, num_shards, shard_index) -> PerRecordData
    # (reference input_data_pipeline.py:211-217 custom_input_fn)
    custom_input_fn: Optional[str] = None

    def __post_init__(self):
        assert self.batch_size > 0, "Batch size must be positive number"
        if self.regularize_bias:
            assert self.has_intercept, "Intercept must be used when it is regularized"
        assert self.feature_bag or self.has_intercept, \
            "Either intercept or feature bag must be used"


@dataclass
class FixedLRParams(LRParams):
    """Fixed-effect extras (reference fixed_effect_lr_lbfgs_model.py:55-71).

    Additions: `dtype` selects the on-device solve precision; `train_chunk_size`
    bounds the per-step device batch when scanning very large datasets.
    """
    copy_to_local: bool = False
    disable_fixed_effect_scoring_after_training: bool = False
    fixed_effect_variance_mode: Optional[str] = None
    dtype: str = "float32"
    train_chunk_size: int = 0       # 0 = whole shard in one chunk
    # out-of-core ingestion: decode the shard in bounded-host-memory chunks of
    # this many records, shipping each to HBM as it decodes (host RAM holds
    # ONE chunk; the dataset lives sharded on the mesh). 0 = load eagerly.
    # Tfrecord input without custom_input_fn only; composes with multi-host
    # (each process streams its own file shard, shapes agreed at stream end).
    stream_chunk_rows: int = 0
    # gradient strategy (one of GRAD_MODES): "block" is the two-level one-hot
    # decomposition (gather/scatter as hi/lo matmuls, any feature count),
    # "onehot" densifies chunks against the full D (small D only), "scatter"
    # is the gather/scatter-add path, "segment" the feature-sorted
    # segment-sum, "hybrid" the hot/cold feature split for the wide-D
    # power-law regime (top-hot_features ids through block's compact path,
    # cold tail through per-entry gather/scatter; degrades to scatter when
    # the data has no hot set), "auto" picks by feature count
    grad_mode: str = "auto"
    onehot_max_features: int = 16384
    block_min_features: int = 1024  # auto: block above, onehot at/below
    # auto: block's ceiling — its cost is O(D) while scatter's is
    # D-independent; past it auto takes the hot/cold hybrid
    block_max_features: int = 700_000
    # hybrid mode: compact hot-set size (top-A features by batch frequency)
    # and the cold-entry fraction above which the split stops paying and the
    # builder falls back to plain scatter (data-driven, e.g. uniform ids).
    # 0 = ADAPTIVE: the builder evaluates its cost model at pow-2 candidate
    # sizes against the batch's own frequency profile (steeper distribution
    # -> smaller hot set). Explicit values pin A.
    hot_features: int = 0
    hybrid_cold_max_frac: float = 0.5
    block_chunk_size: int = 8192    # records per scan step in block mode
    # dot precision of the block/hybrid one-hot products: "float32" is
    # float32-accurate (Precision.HIGHEST; "highest" is its old alias),
    # "bf16x2" is the exact two-term bf16 split (~2^-17 relative), "default"
    # is the backend's fastest mode (one bf16 or TF32 pass: rounds θ, unfit
    # for solver parity)
    block_precision: str = "float32"

    def __post_init__(self):
        super().__post_init__()
        assert self.fixed_effect_variance_mode is None \
            or self.fixed_effect_variance_mode in _VARIANCE_MODES
        if self.grad_mode not in GRAD_MODES:
            raise ValueError(f"unknown grad_mode {self.grad_mode!r}; choose "
                             f"one of {', '.join(GRAD_MODES)}")


@dataclass
class REParams(LRParams):
    """Random-effect extras (reference random_effect_lr_lbfgs_model.py:34-53).

    The queue/consumer knobs of the reference are process-pool artifacts; their
    device-side analogs are the bucketing knobs.
    """
    partition_entity: Optional[str] = None
    enable_local_indexing: bool = False
    random_effect_variance_mode: Optional[str] = None
    disable_random_effect_scoring_after_training: bool = False
    # Reference knobs kept for config compatibility (no-ops here):
    max_training_queue_size: int = 10
    training_queue_timeout_in_seconds: int = 300
    num_of_consumers: int = 2
    # additions:
    dtype: str = "float32"
    # "auto" = Newton–Cholesky for small per-entity dims (batched dense path),
    # L-BFGS otherwise; both reach the same convex optimum (tests verify).
    batch_solver: str = "auto"   # "auto"|"lbfgs"|"newton"|"newton_dual"
    newton_max_dim: int = 128       # auto threshold on 1+u_cap
    # past newton_max_dim, when samples-per-entity < dim, Newton runs in
    # SAMPLE space (Woodbury: n×n kernel Cholesky instead of dim×dim) —
    # Newton-rate convergence with no [B, dim, dim] Hessian; this caps the
    # [B, n, n] kernel memory
    dual_newton_max_elems: int = 200_000_000
    # otherwise L-BFGS runs on DENSIFIED [B, n, dim] matrices (batched dense
    # matvecs) whenever the bucket fits this element budget; per-lane sparse
    # gather/scatter is the last resort
    dense_lbfgs_max_elems: int = 200_000_000
    # two-phase Newton: run everyone for this many iterations, then compact the
    # unconverged stragglers to the front ON DEVICE (argsort + lax.switch
    # prefix ladder, no host round-trip) and finish them (0 = disabled).
    newton_phase1_iters: int = 0
    # random-effect training plane: "sharded" routes records over the device
    # interconnect to entity-owner shards and groups/packs on device
    # (fit_records_sharded — the multi-chip plane); "host" groups/buckets in
    # numpy (fit_groups); "auto" takes the device plane whenever the feature
    # bag is rectangular (padded [N, K]) AND the mesh has >1 device — on a
    # 1-device mesh there is nothing to route.
    # Under multi-process, sharded solves each process's entities on
    # its LOCAL mesh; the cross-process level stays partition round-robin +
    # model files (≡ random_effect_driver.py:60-68).
    re_mode: str = "auto"   # "auto"|"host"|"sharded"
    # out-of-core RE ingestion: decode the partition in bounded-host-memory
    # chunks of this many ENTITIES (one SequenceExample frame = one entity, so
    # chunks are entity-complete and every entity's records stay whole); each
    # chunk trains through the configured plane and the model tables merge.
    # 0 = load the whole partition eagerly. Native tfrecord decoder only.
    stream_chunk_entities: int = 0

    def __post_init__(self):
        super().__post_init__()
        assert self.random_effect_variance_mode is None \
            or self.random_effect_variance_mode in _VARIANCE_MODES
        assert self.batch_solver in ("auto", "lbfgs", "newton", "newton_dual")
        assert self.re_mode in ("auto", "host", "sharded")
