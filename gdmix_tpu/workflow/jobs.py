"""Data-job CLI: the spark-submit equivalents, one subcommand per job.

``python -m gdmix_tpu.workflow.jobs <job> --flags`` with the reference's
camelCase flag names (gdmix-data scopt parsers,
/root/reference/gdmix-data/src/main/scala/com/linkedin/gdmix/parsers/*.scala):

  partitioner        ↔ com.linkedin.gdmix.data.DataPartitioner
  evaluator          ↔ com.linkedin.gdmix.evaluation.Evaluator
  best-model         ↔ com.linkedin.gdmix.data.BestModelSelector
  lr-model-splitter  ↔ com.linkedin.gdmix.model.LrModelSplitter
  offset-updater     ↔ com.linkedin.gdmix.data.OffsetUpdater
  metadata-generator ↔ com.linkedin.gdmix.data.MetadataGenerator
"""
from __future__ import annotations

import argparse
import logging
import sys

logging.basicConfig(
    format="%(asctime)s:%(levelname)s:%(module)s:%(message)s",
    datefmt="%Y/%m/%d %I:%M:%S", level=logging.INFO)


def _partitioner(argv) -> None:
    p = argparse.ArgumentParser(prog="partitioner")
    p.add_argument("--trainingDataDir")
    p.add_argument("--validationDataDir")
    p.add_argument("--metadataFile", required=True)
    p.add_argument("--partitionId", required=True, help="partition entity column")
    p.add_argument("--numPartitions", type=int, default=1)
    p.add_argument("--dataFormat", default="tfrecord")
    p.add_argument("--featureBag", default=None)
    p.add_argument("--partitionedTrainingDataDir")
    p.add_argument("--partitionedValidationDataDir")
    p.add_argument("--outputMetadataFile", required=True)
    p.add_argument("--outputPartitionListFile")
    p.add_argument("--predictionScoreColumnName", default="predictionScore")
    p.add_argument("--predictionScorePerCoordinateColumnName",
                   default="predictionScorePerCoordinate")
    p.add_argument("--offsetColumnName", default="offset")
    p.add_argument("--uidColumnName", default="uid")
    p.add_argument("--trainingScoreDir")
    p.add_argument("--trainingScorePerCoordinateDir")
    p.add_argument("--validationScoreDir")
    p.add_argument("--validationScorePerCoordinateDir")
    p.add_argument("--maxNumOfSamplesPerModel", type=int, default=None)
    p.add_argument("--minNumOfSamplesPerModel", type=int, default=None)
    p.add_argument("--savePassiveData", default="true")
    a = p.parse_args(argv)

    from gdmix_tpu.data.partitioner import PartitionerConfig, run_partitioner
    cfg = PartitionerConfig(
        partition_entity=a.partitionId, num_partitions=a.numPartitions,
        min_samples=a.minNumOfSamplesPerModel,
        max_samples=a.maxNumOfSamplesPerModel,
        save_passive_data=a.savePassiveData.lower() in ("true", "1"),
        offset_column_name=a.offsetColumnName,
        uid_column_name=a.uidColumnName,
        prediction_score_column_name=a.predictionScoreColumnName,
        prediction_score_per_coordinate_column_name=
        a.predictionScorePerCoordinateColumnName)
    run_partitioner(
        training_data_dir=a.trainingDataDir,
        validation_data_dir=a.validationDataDir,
        metadata_file=a.metadataFile,
        output_metadata_file=a.outputMetadataFile,
        partitioned_training_data_dir=a.partitionedTrainingDataDir,
        partitioned_validation_data_dir=a.partitionedValidationDataDir,
        output_partition_list_file=a.outputPartitionListFile,
        config=cfg, feature_bag=a.featureBag,
        training_score_dir=a.trainingScoreDir,
        training_score_per_coordinate_dir=a.trainingScorePerCoordinateDir,
        validation_score_dir=a.validationScoreDir,
        validation_score_per_coordinate_dir=a.validationScorePerCoordinateDir)


def _evaluator(argv) -> None:
    p = argparse.ArgumentParser(prog="evaluator")
    p.add_argument("--metricsInputDir", required=True)
    p.add_argument("--outputMetricFile", required=True)
    p.add_argument("--labelColumnName", default="response")
    p.add_argument("--predictionColumnName", default="predictionScore")
    p.add_argument("--metricName", default="auc", choices=["auc", "mse"])
    a = p.parse_args(argv)
    from gdmix_tpu.data.evaluator import run_evaluator
    result = run_evaluator(a.metricsInputDir, a.outputMetricFile,
                           a.labelColumnName, a.predictionColumnName,
                           a.metricName)
    print(result)


def _best_model(argv) -> None:
    p = argparse.ArgumentParser(prog="best-model")
    p.add_argument("--inputMetricsPaths", required=True,
                   help="semicolon-separated")
    p.add_argument("--inputModelPaths", default="")
    p.add_argument("--evalMetric", default="auc", choices=["auc", "rmse"])
    p.add_argument("--outputBestModelPath", required=True)
    p.add_argument("--outputBestMetricsPath", default=None)
    p.add_argument("--hyperparameters", default=None, help="base64 json")
    p.add_argument("--copyBestOutput", default="false")
    a = p.parse_args(argv)
    from gdmix_tpu.data.best_model import select_best_model
    best = select_best_model(
        [s.strip() for s in a.inputMetricsPaths.split(";")],
        a.evalMetric, a.outputBestModelPath,
        hyperparameters=a.hyperparameters,
        input_model_paths=[s.strip() for s in a.inputModelPaths.split(";")]
        if a.inputModelPaths else None,
        output_best_metrics_path=a.outputBestMetricsPath,
        copy_best_output=a.copyBestOutput.lower() in ("true", "1"))
    print({"best model index": best})


def _splitter(argv) -> None:
    p = argparse.ArgumentParser(prog="lr-model-splitter")
    p.add_argument("--modelInputDir", required=True)
    p.add_argument("--modelOutputDir", required=True)
    p.add_argument("--numOutputFiles", type=int, default=1)
    a = p.parse_args(argv)
    from gdmix_tpu.data.model_splitter import split_model_file
    n = split_model_file(a.modelInputDir, a.modelOutputDir, a.numOutputFiles)
    print({"models": n})


def _offset_updater(argv) -> None:
    """Flags mirror the reference's OffsetUpdaterParser.scala:8-135; the device
    build additionally takes --metadataFile (+ optional --outputMetadataFile,
    --featureBag) because TFRecord reads need declared metadata where Spark
    infers a DataFrame schema."""
    p = argparse.ArgumentParser(prog="offset-updater")
    p.add_argument("--trainingDataDir", required=True)
    p.add_argument("--trainingScoreDir", required=True)
    p.add_argument("--trainingScorePerCoordinateDir", default=None)
    p.add_argument("--outputTrainingDataDir", required=True)
    p.add_argument("--validationDataDir", default=None)
    p.add_argument("--validationScoreDir", default=None)
    p.add_argument("--validationScorePerCoordinateDir", default=None)
    p.add_argument("--outputValidationDataDir", default=None)
    p.add_argument("--predictionScoreColumnName", default="predictionScore")
    p.add_argument("--predictionScorePerCoordinateColumnName",
                   default="predictionScorePerCoordinate")
    p.add_argument("--dataFormat", default="tfrecord")
    p.add_argument("--offsetColumnName", default="offset")
    p.add_argument("--uidColumnName", default="uid")
    p.add_argument("--numPartitions", type=int, default=0)  # compat no-op
    p.add_argument("--metadataFile", required=True)
    p.add_argument("--outputMetadataFile", default=None)
    p.add_argument("--featureBag", default=None)
    a = p.parse_args(argv)

    from gdmix_tpu.data.offset import run_offset_updater
    common = dict(
        metadata_file=a.metadataFile, output_metadata_file=a.outputMetadataFile,
        data_format=a.dataFormat, feature_bag=a.featureBag,
        offset_column_name=a.offsetColumnName,
        uid_column_name=a.uidColumnName,
        prediction_score_column_name=a.predictionScoreColumnName,
        prediction_score_per_coordinate_column_name=
        a.predictionScorePerCoordinateColumnName)
    n = run_offset_updater(
        a.trainingDataDir, a.trainingScoreDir, a.outputTrainingDataDir,
        per_coordinate_score_dir=a.trainingScorePerCoordinateDir, **common)
    if a.validationDataDir and a.validationScoreDir \
            and a.outputValidationDataDir:
        n += run_offset_updater(
            a.validationDataDir, a.validationScoreDir,
            a.outputValidationDataDir,
            per_coordinate_score_dir=a.validationScorePerCoordinateDir,
            **common)
    print({"records": n})


def _metadata_generator(argv) -> None:
    p = argparse.ArgumentParser(prog="metadata-generator")
    p.add_argument("--dataDir", default=None,
                   help="dataset to sniff columns from (optional)")
    p.add_argument("--inputMetadataFile", required=True)
    p.add_argument("--outputMetadataFile", required=True)
    p.add_argument("--dataFormat", default="tfrecord")
    p.add_argument("--extraColumns", default=None,
                   help="name:dtype[,name:dtype...] to declare explicitly")
    a = p.parse_args(argv)
    from gdmix_tpu.data.metadata_gen import run_metadata_generator
    extras = None
    if a.extraColumns:
        extras = dict(kv.split(":") for kv in a.extraColumns.split(","))
    md = run_metadata_generator(a.dataDir, a.inputMetadataFile,
                                a.outputMetadataFile, a.dataFormat, extras)
    print({"columns": len(md.features) + len(md.labels)})


_JOBS = {
    "partitioner": _partitioner,
    "evaluator": _evaluator,
    "best-model": _best_model,
    "lr-model-splitter": _splitter,
    "offset-updater": _offset_updater,
    "metadata-generator": _metadata_generator,
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in _JOBS:
        raise SystemExit(f"usage: python -m gdmix_tpu.workflow.jobs "
                         f"{{{','.join(_JOBS)}}} --flags")
    _JOBS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
