"""MetadataGenerator: derive/update tensor_metadata.json from dataset schemas.

The standalone equivalent of the reference's MetadataGenerator
(/root/reference/gdmix-data/src/main/scala/com/linkedin/gdmix/data/
MetadataGenerator.scala): `addColumnsToMetadata` (:59-82) appends columns found
in a DataFrame schema but absent from the input metadata — simple numeric
columns and simple numeric arrays get shape []; `<bag>_indices`/`<bag>_values`
pairs of a sparse tensor are kept under the root name for tfrecord
(`isSparseColumnComponent`, :262-286); complex columns are an error. Where the
reference inspects the Spark DataFrame schema, this job sniffs the first
records of the dataset itself (there is no JVM schema object on a device host).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

from gdmix_tpu import constants
from gdmix_tpu.io.metadata import DatasetMetadata, TensorInfo
from gdmix_tpu.io import fs

logger = logging.getLogger(__name__)

INDICES_SUFFIX = "_indices"
VALUES_SUFFIX = "_values"


def _dtype_of(values) -> str:
    v = values[0] if isinstance(values, (list, tuple)) and values else values
    if isinstance(v, bool):
        return "int"
    if isinstance(v, int):
        return "long"
    if isinstance(v, float):
        return "float"
    if isinstance(v, (bytes, str)):
        return "string"
    raise ValueError(f"cannot infer a dtype for value {v!r}")


def sniff_columns(data_path: str, data_format: str = constants.TFRECORD,
                  sample_records: int = 16) -> Dict[str, Tuple[str, bool]]:
    """Inspect the first records of a dataset: {column: (dtype, is_array)}.

    is_array mirrors the reference's `isSimpleArrayTypeColumn`: a column whose
    records carry more than one value (variable length ⇒ shape [])."""
    from gdmix_tpu.io.shard import shard_input_files
    files, _ = shard_input_files(data_path, 1, 0)
    out: Dict[str, Tuple[str, bool]] = {}
    seen = 0
    if data_format == constants.TFRECORD:
        from gdmix_tpu.io import proto, tfrecord
        for f in files:
            for payload in tfrecord.read_tfrecords(f):
                ex = proto.decode_example(payload)
                for name, vals in ex.items():
                    dtype = _dtype_of(vals)
                    is_array = len(vals) != 1 or out.get(name, (None, False))[1]
                    out[name] = (dtype, is_array)
                seen += 1
                if seen >= sample_records:
                    return out
    else:
        from gdmix_tpu.io import avro
        for f in files:
            for rec in avro.read_records(f):
                for name, v in rec.items():
                    if isinstance(v, dict):
                        raise ValueError(
                            f"Can not handle complex column {name}")
                    is_array = isinstance(v, list)
                    if is_array and v and isinstance(v[0], dict):
                        # NTV bags etc. — complex, skip like the reference
                        # errors on structs (handled upstream by conversion)
                        raise ValueError(
                            f"Can not handle complex column {name}")
                    dtype = _dtype_of(v if not is_array else (v or [0.0]))
                    out[name] = (dtype,
                                 is_array or out.get(name, (None, False))[1])
                seen += 1
                if seen >= sample_records:
                    return out
    return out


def _is_sparse_component(metadata: DatasetMetadata, name: str) -> bool:
    """`<root>_indices` / `<root>_values` of a sparse metadata column
    (reference isSparseColumnComponent, MetadataGenerator.scala:262-286)."""
    for suffix in (INDICES_SUFFIX, VALUES_SUFFIX):
        if name.endswith(suffix):
            root = name[: -len(suffix)]
            t = metadata.tensors().get(root)
            if t is not None and t.is_sparse:
                return True
    return False


def add_columns_to_metadata(columns: Dict[str, Tuple[str, bool]],
                            input_metadata_file: str,
                            output_metadata_file: str,
                            data_format: str = constants.TFRECORD
                            ) -> DatasetMetadata:
    """Append dataset columns missing from the metadata (reference
    addColumnsToMetadata :59-82 / appendNewColumns :170-215)."""
    metadata = DatasetMetadata.from_file(input_metadata_file)
    known = metadata.tensors()
    for name, (dtype, _is_array) in sorted(columns.items()):
        if name in known:
            continue
        if data_format == constants.TFRECORD and \
                _is_sparse_component(metadata, name):
            continue
        metadata.features.append(
            TensorInfo(name=name, dtype=dtype, shape=[], is_sparse=False))
        logger.info("metadata: appended column %s (%s)", name, dtype)
    fs.makedirs(os.path.dirname(output_metadata_file) or ".", exist_ok=True)
    metadata.save(output_metadata_file)
    return metadata


def run_metadata_generator(data_path: Optional[str],
                           input_metadata_file: str,
                           output_metadata_file: str,
                           data_format: str = constants.TFRECORD,
                           extra_columns: Optional[Dict[str, str]] = None
                           ) -> DatasetMetadata:
    """Standalone job: metadata ∪ dataset columns (∪ declared extras, e.g. the
    offset column a score join is about to add)."""
    columns = (sniff_columns(data_path, data_format) if data_path else {})
    for name, dtype in (extra_columns or {}).items():
        columns.setdefault(name, (dtype, False))
    return add_columns_to_metadata(columns, input_metadata_file,
                                   output_metadata_file, data_format)
