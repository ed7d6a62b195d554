"""Kubernetes workflow surface: GPU Job manifests + a kubectl launcher.

The reference ships this as Kubeflow Pipeline container ops that template
TFJob / SparkApplication CRDs (container_ops.py:22-190) plus sidecar launcher
images that create a CRD and poll its conditions until Succeeded/Failed
(launch_crd.py:25-152, launch_tfjob.py:36-148). The SPMD equivalent needs
neither custom resources nor operator installs:

* every trainer stage is ONE SPMD program per host, so a multi-host stage is a
  plain `batch/v1` Job with `completionMode: Indexed` — the pod's
  JOB_COMPLETION_INDEX is `jax.process_index()`, and a headless Service gives
  index 0 a stable DNS name for `jax.distributed.initialize` (the same env
  contract as distributed.maybe_initialize_distributed);
* data jobs (partitioner / evaluator / ...) replace spark-submit with
  single-pod CPU Jobs on this package's CLI;
* dependency ordering is done by the client (launch_dag), not `.after()`
  chains inside a KFP DSL — the DAG is the same `generate_job_dag` output
  that every other mode consumes.

`compile_kubernetes` emits the manifests; `launch_job` / `launch_dag` drive
them through kubectl with the reference launcher's contract: create, poll the
Job's Complete/Failed conditions, raise on failure or timeout, optionally
delete on completion.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import time
from typing import Dict, List, Optional

import yaml

from gdmix_tpu.workflow.config import WorkflowConfig
from gdmix_tpu.workflow.distributed import DEVICE_JOB_TYPES, generate_job_dag

logger = logging.getLogger(__name__)


def _sanitize(name: str) -> str:
    """RFC-1123 label: lowercase alphanumerics and '-'."""
    out = "".join(c if c.isalnum() else "-" for c in name.lower())
    return out.strip("-")[:63].rstrip("-")


def _unique_names(jobs: List[dict]) -> Dict[str, str]:
    """DAG name → sanitized K8s name, de-duplicated: sanitization can
    collapse distinct names ('per_user' vs 'per-user') — collisions get a
    deterministic numeric suffix so no plan entry silently shadows another."""
    out: Dict[str, str] = {}
    seen: Dict[str, int] = {}
    for j in jobs:
        base = _sanitize(j["name"])
        n = seen.get(base, 0)
        seen[base] = n + 1
        out[j["name"]] = base if n == 0 else \
            _sanitize(f"{base[:57]}-{n + 1}")
    return out


def job_manifest(job: dict, *,
                 namespace: str = "default",
                 image: str = "gdmix-tpu",
                 num_hosts: int = 1,
                 gpu_resource: str = "nvidia.com/gpu",
                 gpus_per_host: int = 4,
                 gpu_accelerator: Optional[str] = None,
                 memory: str = "4Gi",
                 data_volume: Optional[dict] = None,
                 env: Optional[Dict[str, str]] = None,
                 backoff_limit: int = 2,
                 coordinator_port: int = 8476,
                 k8s_name: Optional[str] = None) -> List[dict]:
    """One DAG node → [batch/v1 Job] (+ headless Service when multi-host).

    Multi-host trainer Jobs use Indexed completion: pod i exports
    PROCESS_ID=i, NUM_PROCESSES=num_hosts and COORDINATOR_ADDRESS pointing at
    pod 0 through the headless service — exactly what
    `gdmix_tpu.workflow.distributed.maybe_initialize_distributed` consumes.
    Trainer pods request `gpus_per_host` GPUs through the NVIDIA device
    plugin's `nvidia.com/gpu` resource; `gpu_accelerator` (e.g.
    "nvidia-h100-80gb") pins the GPU model with GKE's accelerator node
    selector. Data jobs request no GPU.
    """
    name = k8s_name or _sanitize(job["name"])
    is_trainer = job["type"] in DEVICE_JOB_TYPES
    hosts = num_hosts if is_trainer else 1

    env_list = [{"name": k, "value": str(v)} for k, v in (env or {}).items()]
    resources: dict = {"limits": {"memory": memory},
                       "requests": {"memory": memory}}
    node_selector: Dict[str, str] = {}
    if is_trainer:
        resources["limits"][gpu_resource] = gpus_per_host
        resources["requests"][gpu_resource] = gpus_per_host
        if gpu_accelerator:
            node_selector["cloud.google.com/gke-accelerator"] = gpu_accelerator

    manifests: List[dict] = []
    if hosts > 1:
        # headless service so <name>-0.<name> resolves before pods are Ready
        manifests.append({
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": namespace,
                         "labels": {"app": name}},
            "spec": {"clusterIP": "None",
                     # workers must resolve pod 0's DNS BEFORE it is Ready
                     # (jax.distributed.initialize runs at startup on all
                     # pods at once) — same as StatefulSet/JobSet coordinators
                     "publishNotReadyAddresses": True,
                     "selector": {"job-name": name},
                     "ports": [{"port": coordinator_port,
                                "name": "jax-coordinator"}]},
        })
        env_list += [
            {"name": "PROCESS_ID",
             "valueFrom": {"fieldRef": {
                 "fieldPath": "metadata.annotations["
                              "'batch.kubernetes.io/job-completion-index']"}}},
            {"name": "NUM_PROCESSES", "value": str(hosts)},
            {"name": "COORDINATOR_ADDRESS",
             "value": f"{name}-0.{name}.{namespace}.svc:{coordinator_port}"},
        ]

    container = {
        "name": "gdmix-tpu",
        "image": image,
        "command": list(job["command"]),
        "resources": resources,
        "env": env_list,
    }
    pod_spec: dict = {"containers": [container],
                      "restartPolicy": "OnFailure"}
    if node_selector:
        pod_spec["nodeSelector"] = node_selector
    if data_volume:
        container["volumeMounts"] = [{"name": "gdmix-data",
                                      "mountPath": data_volume["mountPath"]}]
        pod_spec["volumes"] = [{"name": "gdmix-data",
                                **{k: v for k, v in data_volume.items()
                                   if k != "mountPath"}}]

    job_spec: dict = {
        "backoffLimit": backoff_limit,
        "template": {"metadata": {"labels": {"app": name}},
                     "spec": pod_spec},
    }
    if hosts > 1:
        job_spec.update(completions=hosts, parallelism=hosts,
                        completionMode="Indexed")
        # stable per-index pod DNS for the coordinator address
        job_spec["template"]["spec"]["subdomain"] = name
        job_spec["template"]["spec"]["setHostnameAsFQDN"] = False

    manifests.append({
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": {"app": name,
                                "gdmix-tpu/type": job["type"]}},
        "spec": job_spec,
    })
    return manifests


def compile_kubernetes(config_path: str, output_dir: str,
                       **overrides) -> List[dict]:
    """Compile the workflow into Kubernetes manifests: one YAML per DAG node
    (Service+Job documents) plus `plan.json` recording launch order and
    dependencies. Resource knobs come from the config's `k8s_config` block
    (namespace, image, num_hosts, gpu_resource, gpus_per_host,
    gpu_accelerator, memory, data_volume) — the reference reads the same
    from its tfjob_config/spark_config blocks (container_ops.py:22-60);
    `tfjob_config.workerNum` is honored as a num_hosts fallback. Keyword
    overrides win over the config."""
    config = WorkflowConfig.from_file(config_path)
    knobs = dict(config.extras.get("k8s_config") or {})
    tfjob = config.extras.get("tfjob_config") or {}
    if "num_hosts" not in knobs and tfjob.get("workerNum"):
        knobs["num_hosts"] = int(tfjob["workerNum"])
    knobs.update(overrides)

    dag = generate_job_dag(config)
    if len(dag) > 1 and not knobs.get("data_volume"):
        logger.warning(
            "k8s_config.data_volume is not set: stages hand artifacts to each "
            "other through %s, which must be shared storage mounted into every "
            "pod (set data_volume, or bake a shared mount into the image) — "
            "without it each Job writes to its pod's ephemeral filesystem and "
            "downstream Jobs will fail.", config.output_dir)
    names = _unique_names(dag)
    namespace = knobs.get("namespace", "default")
    os.makedirs(output_dir, exist_ok=True)
    plan = []
    for i, job in enumerate(dag):
        manifests = job_manifest(job, k8s_name=names[job["name"]], **knobs)
        fname = f"{i:02d}-{names[job['name']]}.yaml"
        with open(os.path.join(output_dir, fname), "w") as f:
            yaml.safe_dump_all(manifests, f, sort_keys=False)
        plan.append({"name": names[job["name"]],
                     "manifest": fname,
                     "depends_on": [names[d] for d in job["depends_on"]],
                     "type": job["type"]})
    with open(os.path.join(output_dir, "plan.json"), "w") as f:
        json.dump({"name": "gdmix-tpu-workflow", "namespace": namespace,
                   "jobs": plan}, f, indent=2)
    logger.info("Compiled %d jobs to %s", len(plan), output_dir)
    return plan


# ------------------------------------------------------------- launcher ----


def _kubectl(args: List[str], kubectl: str = "kubectl",
             timeout: float = 300.0) -> str:
    # a per-call timeout so a hung API server surfaces as an error instead of
    # blocking the launcher past its own job deadline forever
    proc = subprocess.run([kubectl] + args, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{kubectl} {' '.join(args)} failed "
                           f"(exit {proc.returncode}): {proc.stderr[-2000:]}")
    return proc.stdout


def _job_condition(status: dict) -> Optional[str]:
    for cond in status.get("conditions") or []:
        if cond.get("status") == "True" and cond.get("type") in (
                "Complete", "Failed"):
            return cond["type"]
    return None


def launch_job(manifest_file: str, name: str, *,
               namespace: str = "default",
               kubectl: str = "kubectl",
               timeout: float = 86400.0,
               poll_interval: float = 30.0,
               delete_after: bool = False) -> dict:
    """Create the Job and poll until its Complete/Failed condition — the
    reference launcher contract (launch_crd.py:31-101: get, check expected
    conditions, sleep poll_interval, raise on timeout; launch_tfjob.py:36-44:
    Succeeded|Failed). Raises RuntimeError on Failed or timeout; returns the
    final Job object. `delete_after` mirrors delete_finished_tfjob."""
    _kubectl(["apply", "-f", manifest_file], kubectl)
    deadline = time.monotonic() + timeout
    while True:
        out = _kubectl(["get", "job", name, "-n", namespace, "-o", "json"],
                       kubectl)
        obj = json.loads(out)
        cond = _job_condition(obj.get("status", {}))
        if cond == "Complete":
            logger.info("Job %s completed.", name)
            if delete_after:
                _kubectl(["delete", "-f", manifest_file,
                          "--wait=false"], kubectl)
            return obj
        if cond == "Failed":
            raise RuntimeError(f"Job {name} failed: "
                               f"{json.dumps(obj.get('status', {}))[:2000]}")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise RuntimeError(f"Timeout waiting for job {name} to complete")
        logger.info("Waiting for job %s (active=%s succeeded=%s)...", name,
                    obj.get("status", {}).get("active", 0),
                    obj.get("status", {}).get("succeeded", 0))
        time.sleep(min(poll_interval, remaining))


def launch_dag(plan_dir: str, *,
               namespace: Optional[str] = None,
               kubectl: str = "kubectl",
               timeout_per_job: float = 86400.0,
               poll_interval: float = 30.0,
               delete_after: bool = False) -> List[str]:
    """Launch a compiled plan (compile_kubernetes output dir) in dependency
    order, one Job at a time — the role the reference splits across KFP
    `.after()` chains and per-job launcher pods. The namespace defaults to
    the one the plan was COMPILED with (plan.json), so polling always targets
    the namespace `kubectl apply` created the Job in. Returns completion
    order."""
    from gdmix_tpu.workflow.distributed import iter_dependency_order
    with open(os.path.join(plan_dir, "plan.json")) as f:
        plan_obj = json.load(f)
    ns = namespace or plan_obj.get("namespace", "default")
    done: List[str] = []
    for job in iter_dependency_order(plan_obj["jobs"]):
        launch_job(os.path.join(plan_dir, job["manifest"]), job["name"],
                   namespace=ns, kubectl=kubectl,
                   timeout=timeout_per_job, poll_interval=poll_interval,
                   delete_after=delete_after)
        done.append(job["name"])
    return done
