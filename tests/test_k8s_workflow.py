"""Kubernetes workflow surface: manifest compilation + kubectl launcher.

Mirrors the reference's distributed mode (container_ops.py TFJob/Spark specs,
launch_crd.py create-poll-raise contract) — here as batch/v1 Indexed Jobs and
a kubectl driver exercised against a fake kubectl on PATH."""
import json
import os
import stat
import sys

import pytest
import yaml

from gdmix_tpu.workflow.k8s import (compile_kubernetes, job_manifest,
                                    launch_dag, launch_job)
from tests.test_e2e_pipeline import _config


def _write_cfg(tmp_path, extras=None):
    cfg = _config("/data/movieLens", str(tmp_path / "out"))
    obj = {"output_dir": cfg.output_dir,
           "fixed_effect_config": cfg.fixed_effect_config,
           "random_effect_config": cfg.random_effect_config,
           **(extras or {})}
    p = str(tmp_path / "cfg.yaml")
    with open(p, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False)
    return p


def test_compile_kubernetes_manifests(tmp_path):
    cfg = _write_cfg(tmp_path, extras={
        "k8s_config": {"namespace": "gdmix", "image": "gdmix-tpu:v1",
                       "num_hosts": 4, "gpus_per_host": 8,
                       "gpu_accelerator": "nvidia-h100-80gb",
                       "memory": "8Gi"}})
    out = str(tmp_path / "k8s")
    plan = compile_kubernetes(cfg, out)
    # 2 FE jobs + 3 per RE coordinate × 2 coordinates = 8 nodes
    assert len(plan) == 8
    with open(os.path.join(out, "plan.json")) as f:
        saved = json.load(f)["jobs"]
    assert [j["name"] for j in saved] == [j["name"] for j in plan]

    # trainer node: Indexed multi-host Job + headless Service, GPU resources
    fe_train = next(j for j in plan if j["type"] == "gdmix_tpu_train")
    docs = list(yaml.safe_load_all(
        open(os.path.join(out, fe_train["manifest"]))))
    assert [d["kind"] for d in docs] == ["Service", "Job"]
    svc, job = docs
    assert svc["spec"]["clusterIP"] == "None"
    spec = job["spec"]
    assert (spec["completions"], spec["parallelism"],
            spec["completionMode"]) == (4, 4, "Indexed")
    pod = spec["template"]["spec"]
    c = pod["containers"][0]
    assert c["image"] == "gdmix-tpu:v1"
    assert c["resources"]["limits"]["nvidia.com/gpu"] == 8
    assert c["resources"]["requests"]["nvidia.com/gpu"] == 8
    assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == \
        "nvidia-h100-80gb"
    env = {e["name"]: e for e in c["env"]}
    # the jax.distributed env contract (distributed.py:38-44)
    assert env["NUM_PROCESSES"]["value"] == "4"
    assert env["COORDINATOR_ADDRESS"]["value"].startswith(
        job["metadata"]["name"] + "-0.")
    assert "job-completion-index" in \
        env["PROCESS_ID"]["valueFrom"]["fieldRef"]["fieldPath"]
    assert c["command"][0:3] == ["python", "-m", "gdmix_tpu.gdmix"]

    # data node: single-pod CPU Job, no service, no GPU request
    part = next(j for j in plan if j["type"] == "gdmix_tpu_partition")
    docs = list(yaml.safe_load_all(
        open(os.path.join(out, part["manifest"]))))
    assert [d["kind"] for d in docs] == ["Job"]
    spec = docs[0]["spec"]
    assert "completions" not in spec
    limits = spec["template"]["spec"]["containers"][0]["resources"]["limits"]
    assert "nvidia.com/gpu" not in limits
    assert "nodeSelector" not in spec["template"]["spec"]
    # dependency edges survive sanitization
    assert part["depends_on"] == ["global-compute-metric"]


def test_tfjob_config_worker_num_fallback(tmp_path):
    """The reference's tfjob_config.workerNum (tests/resources/
    lr-movieLens.yaml) maps to num_hosts when no k8s_config block overrides
    it."""
    cfg = _write_cfg(tmp_path, extras={"tfjob_config": {"workerNum": 2}})
    plan = compile_kubernetes(cfg, str(tmp_path / "k8s"))
    fe_train = next(j for j in plan if j["type"] == "gdmix_tpu_train")
    docs = list(yaml.safe_load_all(
        open(os.path.join(str(tmp_path / "k8s"), fe_train["manifest"]))))
    assert docs[-1]["spec"]["completions"] == 2


def _fake_kubectl(tmp_path, polls_until_done=2, final="Complete"):
    """A kubectl stand-in: `apply` records the manifest; `get job` reports no
    condition for N polls then the final condition; `delete` records it."""
    state = tmp_path / "kubectl-state"
    state.mkdir(exist_ok=True)
    script = tmp_path / "kubectl"
    script.write_text(f"""#!{sys.executable}
import json, os, sys
state = {str(str(state))!r}
args = sys.argv[1:]
if args[0] == "apply":
    open(os.path.join(state, "applied"), "a").write(args[2] + "\\n")
    sys.exit(0)
if args[0] == "delete":
    open(os.path.join(state, "deleted"), "a").write(args[2] + "\\n")
    sys.exit(0)
if args[0] == "get":
    name = args[2]
    cnt_file = os.path.join(state, "polls-" + name)
    n = int(open(cnt_file).read()) if os.path.exists(cnt_file) else 0
    open(cnt_file, "w").write(str(n + 1))
    status = {{"active": 1}}
    if n + 1 >= {polls_until_done}:
        status = {{"conditions": [{{"type": {final!r}, "status": "True"}}]}}
    print(json.dumps({{"metadata": {{"name": name}}, "status": status}}))
    sys.exit(0)
sys.exit(1)
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), state


def test_launch_job_waits_for_complete(tmp_path):
    kubectl, state = _fake_kubectl(tmp_path, polls_until_done=3)
    manifest = tmp_path / "job.yaml"
    manifest.write_text("apiVersion: batch/v1\nkind: Job\n")
    obj = launch_job(str(manifest), "my-job", kubectl=kubectl,
                     poll_interval=0.01, timeout=60.0, delete_after=True)
    assert obj["status"]["conditions"][0]["type"] == "Complete"
    assert (state / "applied").read_text().strip() == str(manifest)
    assert (state / "deleted").read_text().strip() == str(manifest)


def test_launch_job_raises_on_failed_and_timeout(tmp_path):
    kubectl, _ = _fake_kubectl(tmp_path, polls_until_done=1, final="Failed")
    manifest = tmp_path / "job.yaml"
    manifest.write_text("apiVersion: batch/v1\nkind: Job\n")
    with pytest.raises(RuntimeError, match="failed"):
        launch_job(str(manifest), "bad-job", kubectl=kubectl,
                   poll_interval=0.01, timeout=60.0)
    (tmp_path / "t2").mkdir(exist_ok=True)
    kubectl2, _ = _fake_kubectl(tmp_path / "t2", polls_until_done=10**9)
    with pytest.raises(RuntimeError, match="Timeout"):
        launch_job(str(manifest), "slow-job", kubectl=kubectl2,
                   poll_interval=0.01, timeout=0.05)


def test_launch_dag_dependency_order(tmp_path):
    cfg = _write_cfg(tmp_path)
    out = str(tmp_path / "k8s")
    compile_kubernetes(cfg, out)
    kubectl, state = _fake_kubectl(tmp_path, polls_until_done=1)
    order = launch_dag(out, kubectl=kubectl, poll_interval=0.01,
                       timeout_per_job=60.0)
    assert len(order) == 8
    # every job launched after all of its dependencies
    with open(os.path.join(out, "plan.json")) as f:
        plan = {j["name"]: j for j in json.load(f)["jobs"]}
    pos = {n: i for i, n in enumerate(order)}
    for name, j in plan.items():
        for dep in j["depends_on"]:
            assert pos[dep] < pos[name]


def test_namespace_flows_from_config_to_plan_and_launcher(tmp_path):
    """k8s_config.namespace must survive into the manifests AND plan.json so
    launch_dag polls the namespace apply created the Jobs in (reference
    launcher polls the CR's own namespace, launch_crd.py:53-55)."""
    cfg = _write_cfg(tmp_path, extras={"k8s_config": {"namespace": "gdmix"}})
    out = str(tmp_path / "k8s")
    compile_kubernetes(cfg, out)
    with open(os.path.join(out, "plan.json")) as f:
        plan_obj = json.load(f)
    assert plan_obj["namespace"] == "gdmix"
    docs = list(yaml.safe_load_all(
        open(os.path.join(out, plan_obj["jobs"][0]["manifest"]))))
    assert docs[-1]["metadata"]["namespace"] == "gdmix"
    # the CLI must not clobber the config's namespace with a default
    from gdmix_tpu.workflow.main import main
    out2 = str(tmp_path / "k8s2")
    main(["--config_path", cfg, "--mode", "kubernetes",
          "--k8s_output_dir", out2])
    with open(os.path.join(out2, "plan.json")) as f:
        assert json.load(f)["namespace"] == "gdmix"


def test_sanitize_collisions_get_unique_names(tmp_path):
    from gdmix_tpu.workflow.k8s import _unique_names
    jobs = [{"name": "per_user-tf-train", "type": "gdmix_tpu_train",
             "depends_on": [], "command": ["true"]},
            {"name": "per-user-tf-train", "type": "gdmix_tpu_train",
             "depends_on": [], "command": ["true"]}]
    names = _unique_names(jobs)
    assert len(set(names.values())) == 2
    for n in names.values():  # valid RFC-1123 labels
        assert n == n.strip("-") and len(n) <= 63


def test_launch_job_timeout_respects_full_budget(tmp_path):
    """poll_interval > timeout must not raise before the budget is spent,
    and a job completing within the budget must succeed."""
    import time
    kubectl, _ = _fake_kubectl(tmp_path, polls_until_done=1)
    manifest = tmp_path / "job.yaml"
    manifest.write_text("apiVersion: batch/v1\nkind: Job\n")
    t0 = time.monotonic()
    obj = launch_job(str(manifest), "fast-job", kubectl=kubectl,
                     poll_interval=30.0, timeout=1.0)
    assert obj["status"]["conditions"][0]["type"] == "Complete"
    # Well below the 30s poll_interval a sleep-first implementation would
    # burn; loose enough to tolerate slow subprocess startup on a loaded box.
    assert time.monotonic() - t0 < 20.0


def test_multihost_service_publishes_not_ready_addresses(tmp_path):
    docs = job_manifest({"name": "t", "type": "gdmix_tpu_train",
                         "depends_on": [], "command": ["true"]},
                        num_hosts=2)
    svc = docs[0]
    assert svc["spec"]["publishNotReadyAddresses"] is True


def test_trainer_cli_consumes_distributed_env(monkeypatch):
    """python -m gdmix_tpu.gdmix must initialize jax.distributed from the env
    the kubernetes manifests inject (it is what the Job pods run)."""
    import gdmix_tpu.gdmix as trainer
    calls = {}
    monkeypatch.setattr(
        "gdmix_tpu.workflow.distributed.maybe_initialize_distributed",
        lambda: calls.setdefault("init", True) or {"process_id": 0,
                                                   "num_processes": 1})
    with pytest.raises(Exception):
        # params parsing fails fast on the empty flags — but only AFTER
        # distributed init ran
        trainer.run(["--action=train"])
    assert calls.get("init")


def test_workflow_main_kubernetes_mode(tmp_path):
    from gdmix_tpu.workflow.main import main
    cfg = _write_cfg(tmp_path)
    out = str(tmp_path / "k8s")
    res = main(["--config_path", cfg, "--mode", "kubernetes",
                "--k8s_output_dir", out])
    assert len(res["jobs"]) == 8
    assert os.path.isfile(os.path.join(out, "plan.json"))
