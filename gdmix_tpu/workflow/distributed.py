"""Distributed workflow: job DAG emission + multi-host launch.

The reference compiles a Kubeflow Pipeline of TFJob/SparkApplication CRDs
(gdmix-workflow/src/gdmixworkflow/distributed/container_ops.py). The SPMD
equivalent has no separate Spark cluster or parameter servers to orchestrate —
one SPMD program per host covers every stage — so distribution reduces to:

  1. `generate_job_dag`: the explicit job sequence (for external schedulers —
     each node is a shell command on this package's CLI, chained by the same
     directory contract as the reference's container ops)
  2. `execute_job_dag`: a dependency-aware executor for that DAG — the role of
     the reference's K8s launchers (launch_crd.py:25-152: create, poll for
     condition, fail the pipeline on job failure), with subprocesses instead
     of CRDs and ready-set parallelism instead of `.after()` chaining
  3. `maybe_initialize_distributed`: `jax.distributed.initialize` from env
     (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID — the JAX
     replacement for TF_CONFIG cluster specs)
"""
from __future__ import annotations

import json
import logging
import os

from gdmix_tpu.io import fs
import subprocess
from typing import Dict, List, Optional

from gdmix_tpu.workflow.config import (METRIC, MODELS, PARTITION,
                                       TRAINING_SCORES, VALIDATION_SCORES,
                                       WorkflowConfig)

logger = logging.getLogger(__name__)

# job types that run the JAX trainer on the accelerators; every other type is
# a host-only data job
DEVICE_JOB_TYPES = frozenset({"gdmix_tpu_train"})


def maybe_initialize_distributed() -> Dict[str, int]:
    """Initialize jax.distributed from env if a coordinator is configured.
    Returns {process_id, num_processes}."""
    import jax
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator:
        num_processes = int(os.environ["NUM_PROCESSES"])
        process_id = int(os.environ["PROCESS_ID"])
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
        logger.info("jax.distributed initialized: process %d/%d",
                    process_id, num_processes)
        return {"process_id": process_id, "num_processes": num_processes}
    return {"process_id": 0, "num_processes": 1}


def _flags(d: Dict) -> List[str]:
    return [f"--{k}={v}" for k, v in d.items() if v is not None]


def generate_job_dag(config: WorkflowConfig) -> List[dict]:
    """Explicit job list: [{name, type, depends_on, command}] — the reference's
    gen_workflow chain (workflow_generator.py:66-100) as portable data. Every
    command is COMPLETE and runnable (execute_job_dag runs them; external
    schedulers can too): one argv carries driver + model params, exactly like
    the reference's container ops serialize their params dataclasses."""
    jobs: List[dict] = []
    root = config.output_dir

    (fe_name, fe_conf), = config.fixed_effect_config.items()
    fe_conf = dict(fe_conf)
    fe_gdmix = dict(fe_conf.pop("gdmix_config"))
    fe_dir = os.path.join(root, fe_name)
    jobs.append({
        "name": f"{fe_name}-tf-train",
        "type": "gdmix_tpu_train",
        "depends_on": [],
        "command": ["python", "-m", "gdmix_tpu.gdmix"] + _flags({
            **fe_gdmix, **fe_conf,
            "stage": "fixed_effect",
            "output_model_dir": os.path.join(fe_dir, MODELS),
            "training_score_dir": os.path.join(fe_dir, TRAINING_SCORES),
            "validation_score_dir": os.path.join(fe_dir, VALIDATION_SCORES)}),
    })
    jobs.append({
        "name": f"{fe_name}-compute-metric",
        "type": "gdmix_tpu_evaluate",
        "depends_on": [f"{fe_name}-tf-train"],
        "command": ["python", "-m", "gdmix_tpu.workflow.jobs", "evaluator",
                    f"--metricsInputDir={os.path.join(fe_dir, VALIDATION_SCORES)}",
                    f"--outputMetricFile={os.path.join(fe_dir, METRIC)}",
                    f"--labelColumnName={fe_gdmix.get('label_column_name', 'response')}",
                    f"--predictionColumnName={fe_gdmix.get('prediction_score_column_name', 'predictionScore')}"],
    })

    prev = fe_name
    for name, re_raw in config.random_effect_config.items():
        re_conf = dict(re_raw)
        re_gdmix = dict(re_conf.pop("gdmix_config"))
        num_partitions = int(re_conf.pop("num_partitions", 1))
        re_dir = os.path.join(root, name)
        part_dir = os.path.join(re_dir, PARTITION)
        part_train = os.path.join(part_dir, "trainingData")
        part_valid = os.path.join(part_dir, "validationData")
        part_md = os.path.join(part_dir, "metadata", "tensor_metadata.json")
        part_list = os.path.join(part_dir, "partitionList.txt")
        jobs.append({
            "name": f"{name}-partition",
            "type": "gdmix_tpu_partition",
            "depends_on": [f"{prev}-compute-metric"],
            "command": ["python", "-m", "gdmix_tpu.workflow.jobs",
                        "partitioner"] + _flags({
                "trainingDataDir": re_conf["training_data_dir"],
                "validationDataDir": re_conf.get("validation_data_dir"),
                "metadataFile": re_conf["metadata_file"],
                "partitionId": re_conf["partition_entity"],
                "numPartitions": num_partitions,
                "featureBag": re_conf.get("feature_bag"),
                "partitionedTrainingDataDir": part_train,
                "partitionedValidationDataDir": part_valid,
                "outputMetadataFile": part_md,
                "outputPartitionListFile": part_list,
                "uidColumnName": re_gdmix.get("uid_column_name", "uid"),
                "predictionScoreColumnName": re_gdmix.get(
                    "prediction_score_column_name", "predictionScore"),
                "maxNumOfSamplesPerModel": re_conf.pop("max_samples", None),
                "minNumOfSamplesPerModel": re_conf.pop("min_samples", None),
                "trainingScoreDir": os.path.join(root, prev, TRAINING_SCORES),
                "validationScoreDir": os.path.join(root, prev,
                                                   VALIDATION_SCORES)}),
        })
        train_overrides = dict(re_conf)
        train_overrides.update(
            training_data_dir=part_train, validation_data_dir=part_valid,
            metadata_file=part_md)
        jobs.append({
            "name": f"{name}-tf-train",
            "type": "gdmix_tpu_train",
            "depends_on": [f"{name}-partition"],
            "command": ["python", "-m", "gdmix_tpu.gdmix"] + _flags({
                **re_gdmix, **train_overrides,
                "stage": "random_effect",
                "partition_list_file": part_list,
                "output_model_dir": os.path.join(re_dir, MODELS),
                "training_score_dir": os.path.join(re_dir, TRAINING_SCORES),
                "validation_score_dir": os.path.join(re_dir,
                                                     VALIDATION_SCORES)}),
        })
        jobs.append({
            "name": f"{name}-compute-metric",
            "type": "gdmix_tpu_evaluate",
            "depends_on": [f"{name}-tf-train"],
            "command": ["python", "-m", "gdmix_tpu.workflow.jobs", "evaluator",
                        f"--metricsInputDir={os.path.join(re_dir, VALIDATION_SCORES)}",
                        f"--outputMetricFile={os.path.join(re_dir, METRIC)}",
                        f"--labelColumnName={re_gdmix.get('label_column_name', 'response')}",
                        f"--predictionColumnName={re_gdmix.get('prediction_score_column_name', 'predictionScore')}"],
        })
        prev = name
    return jobs


def iter_dependency_order(jobs: List[dict]):
    """Yield jobs serially in dependency order: a job appears only after all
    of its `depends_on` have been yielded. Raises on unknown deps/deadlock.
    Shared by the kubectl launcher (k8s.launch_dag) and usable by any other
    one-at-a-time runner; execute_job_dag below is the parallel variant."""
    by_name = {j["name"]: j for j in jobs}
    unknown = {d for j in jobs for d in j["depends_on"]} - set(by_name)
    if unknown:
        raise RuntimeError(f"DAG references unknown jobs: {sorted(unknown)}")
    done: set = set()
    pending = dict(by_name)
    while pending:
        name = next((n for n, j in pending.items()
                     if all(d in done for d in j["depends_on"])), None)
        if name is None:
            raise RuntimeError(f"DAG deadlock among {sorted(pending)} "
                               f"(done: {sorted(done)})")
        yield pending.pop(name)
        done.add(name)


def execute_job_dag(jobs: List[dict], max_parallel: int = 1,
                    env: Optional[Dict[str, str]] = None,
                    timeout_per_job: float = 3600.0) -> List[str]:
    """Run a job DAG (from `generate_job_dag` or a compiled JSON file) with
    dependency ordering. Jobs whose dependencies have all succeeded run
    concurrently up to `max_parallel`, except that device jobs
    (DEVICE_JOB_TYPES) run one at a time: a trainer process takes every local
    accelerator (the FE mesh spans them all) and reserves most of each
    card's memory, so a second trainer beside it would fail for want of
    memory. Host-only data jobs may run beside a device job. Any failure
    aborts the pipeline with the failing job's output — the launcher
    contract of the reference's
    `K8sCR.wait_for_condition` (launch_crd.py:31-101). Returns the completion
    order."""
    by_name = {j["name"]: j for j in jobs}
    unknown = {d for j in jobs for d in j["depends_on"]} - set(by_name)
    assert not unknown, f"DAG references unknown jobs: {sorted(unknown)}"
    pending = dict(by_name)
    done: List[str] = []
    running: Dict[str, subprocess.Popen] = {}
    run_env = dict(os.environ, **(env or {}))

    def is_device(name):
        return by_name[name]["type"] in DEVICE_JOB_TYPES

    def ready():
        return [n for n, j in pending.items()
                if all(d in done for d in j["depends_on"])
                and n not in running]

    while pending or running:
        device_busy = any(is_device(n) for n in running)
        launch = []
        for name in ready():
            if len(running) + len(launch) >= max_parallel:
                break
            if is_device(name):
                if device_busy:
                    continue
                device_busy = True
            launch.append(name)
        for name in launch:
            logger.info("DAG: launching %s: %s", name,
                        " ".join(pending[name]["command"]))
            running[name] = subprocess.Popen(
                pending[name]["command"], env=run_env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if not running:
            raise RuntimeError(
                f"DAG deadlock: no runnable job among {sorted(pending)} "
                f"(done: {done})")
        # wait for one running job to finish (poll in submission order)
        name, proc = next(iter(running.items()))
        out, _ = proc.communicate(timeout=timeout_per_job)
        del running[name]
        if proc.returncode != 0:
            for p in running.values():
                p.kill()
            raise RuntimeError(
                f"DAG job {name!r} failed (exit {proc.returncode}):\n"
                f"{out.decode(errors='replace')[-4000:]}")
        logger.info("DAG: %s succeeded", name)
        done.append(name)
        pending.pop(name)
    return done


def compile_dag(config_path: str, output_file: str) -> List[dict]:
    config = WorkflowConfig.from_file(config_path)
    dag = generate_job_dag(config)
    fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with fs.open(output_file, "w") as f:
        json.dump({"name": "gdmix-tpu-workflow", "jobs": dag}, f, indent=2)
    logger.info("Wrote %d-job DAG to %s", len(dag), output_file)
    return dag
