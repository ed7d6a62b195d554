"""Workflow CLI: ``python -m gdmix_tpu.workflow.main --config_path X --mode M``.

Mirrors the reference gdmix-workflow entry (gdmixworkflow/main.py:12-66).
Modes:
  single_node — the reference semantics: file-based handoffs between stages
  in_memory   — the device-resident fast path: in-HBM score ledger, no stage files
  distributed — initialize jax.distributed from env and run single_node SPMD;
                with --compile_dag_to, emit the job DAG instead of running
  dag         — generate the job DAG and EXECUTE it (one subprocess per job,
                dependency-ordered — the reference's launcher role)
  kubernetes  — compile the DAG to batch/v1 Job manifests (+ headless
                Services for multi-host trainer stages) under
                --k8s_output_dir; with --launch, drive them through kubectl
                in dependency order (the reference's KFP/TFJob-launcher role,
                container_ops.py:22-190 + launch_crd.py:25-152)
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

logging.basicConfig(
    format="%(asctime)s:%(levelname)s:%(module)s:%(message)s",
    datefmt="%Y/%m/%d %I:%M:%S", level=logging.INFO)
logger = logging.getLogger(__name__)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="gdmix-tpu workflow")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--mode", default="single_node",
                        choices=["single_node", "in_memory", "distributed",
                                 "dag", "kubernetes"])
    parser.add_argument("--k8s_output_dir", default="k8s-manifests",
                        help="manifest output directory (kubernetes mode)")
    parser.add_argument("--launch", action="store_true",
                        help="kubernetes mode: launch the compiled plan "
                             "through kubectl and wait for completion")
    parser.add_argument("--namespace", default=None,
                        help="kubernetes namespace (kubernetes mode; "
                             "defaults to the config's k8s_config.namespace)")
    parser.add_argument("--num_sweeps", type=int, default=1,
                        help="coordinate-descent sweeps (in_memory mode)")
    parser.add_argument("--re_mode", default=None,
                        choices=["auto", "host", "sharded"],
                        help="random-effect training plane (in_memory mode): "
                             "sharded = device routing + on-device grouping "
                             "(fit_records_sharded), host = numpy grouping; "
                             "auto (default, also a YAML top-level key) takes "
                             "sharded whenever the feature bag is rectangular")
    parser.add_argument("--compile_dag_to", default=None,
                        help="emit the job DAG json here instead of running")
    parser.add_argument("--max_parallel", type=int, default=1,
                        help="concurrent ready jobs (dag mode)")
    parser.add_argument("--resume", action="store_true",
                        help="skip coordinates whose evalSummary.json exists "
                             "(single_node mode: restart a crashed run)")
    # accepted for reference-config compatibility; unused here:
    parser.add_argument("--jar_path", default="", help=argparse.SUPPRESS)
    return parser


def main(args=None) -> dict:
    args = get_parser().parse_args(args)
    if args.compile_dag_to:
        from gdmix_tpu.workflow.distributed import compile_dag
        compile_dag(args.config_path, args.compile_dag_to)
        return {}
    if args.mode == "distributed":
        from gdmix_tpu.workflow.distributed import maybe_initialize_distributed
        maybe_initialize_distributed()
    if args.mode == "kubernetes":
        from gdmix_tpu.workflow.k8s import compile_kubernetes, launch_dag
        overrides = {"namespace": args.namespace} if args.namespace else {}
        plan = compile_kubernetes(args.config_path, args.k8s_output_dir,
                                  **overrides)
        if args.launch:
            order = launch_dag(args.k8s_output_dir)
            logger.info("kubernetes plan complete: %s", order)
            return {"jobs": order}
        logger.info("compiled %d jobs to %s (use --launch to run)",
                    len(plan), args.k8s_output_dir)
        return {"jobs": [j["name"] for j in plan]}
    if args.mode == "dag":
        from gdmix_tpu.workflow.config import WorkflowConfig
        from gdmix_tpu.workflow.distributed import (execute_job_dag,
                                                    generate_job_dag)
        dag = generate_job_dag(WorkflowConfig.from_file(args.config_path))
        order = execute_job_dag(dag, max_parallel=args.max_parallel)
        logger.info("DAG complete: %s", order)
        return {"jobs": order}
    if args.mode == "in_memory":
        from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory
        metrics = run_gdmix_in_memory(args.config_path,
                                      num_sweeps=args.num_sweeps,
                                      re_mode=args.re_mode)
    else:
        from gdmix_tpu.workflow.single_node import run_gdmix_single_node
        metrics = run_gdmix_single_node(args.config_path, resume=args.resume)
    logger.info("workflow metrics: %s", json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
