"""Subprocess runner for the 2-process x 4-virtual-device in-HBM pipeline test.

Usage: python tests/multiproc_pipeline_runner.py <pid> <nproc> <ml_root> <out>
       <port> [re_mode] [pipeline_out]

`pipeline_out` (default: <out>) may be a remote-scheme path (e.g.
fakefs://bucket/run with GDMIX_FAKEFS_ROOT set) — the pipeline's model
exchange, score writes and final artifacts then ride the fs seam against a
shared fake remote store with REAL processes. metrics_<pid>.json always
lands in the local <out>.
Runs the full 3-coordinate coordinate-descent pipeline under jax.distributed:
FE trains SPMD over all 8 devices; RE composes the two parallelism levels —
entities round-robin OWNED per process (model-file exchange) × interconnect routing +
on-device grouping over each process's 4-device LOCAL mesh (re_mode=sharded,
the default plane). Each process writes its metric ladder plus the number of
sharded-plane solves to metrics_<pid>.json for the test to assert on.
"""
import json
import os
import sys

pid, nproc, ml_root, out_dir, port = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
re_mode = sys.argv[6] if len(sys.argv) > 6 else "sharded"
pipeline_out = sys.argv[7] if len(sys.argv) > 7 else out_dir
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gdmix_tpu.models.fixed_effect_lr import FixedEffectLRModel  # noqa: E402
from gdmix_tpu.models.random_effect_lr import RandomEffectLRModel  # noqa: E402
from gdmix_tpu.workflow.pipeline import run_gdmix_in_memory  # noqa: E402
from tests.test_e2e_pipeline import _config  # noqa: E402

# capture model instances so the multi-sweep static-upload counters can be
# asserted (statics cross the link once per view, not
# once per sweep, under multi-host too)
_instances = []
for _cls in (FixedEffectLRModel, RandomEffectLRModel):
    _cls._orig_init = _cls.__init__

    def _rec_init(self, *a, __orig=_cls._orig_init, **kw):
        __orig(self, *a, **kw)
        _instances.append(self)
    _cls.__init__ = _rec_init

sharded_calls = []
_orig = RandomEffectLRModel.fit_records_sharded


def _spy(self, data, schema_params, model_weights=None, mesh=None, **kw):
    # the composed plane must route over the process-LOCAL mesh
    assert mesh is None or len(mesh.devices.flatten()) == len(
        jax.local_devices()), mesh
    sharded_calls.append(self.model_params.partition_entity)
    return _orig(self, data, schema_params, model_weights=model_weights,
                 mesh=mesh, **kw)


RandomEffectLRModel.fit_records_sharded = _spy

metrics = run_gdmix_in_memory(_config(ml_root, pipeline_out), num_sweeps=2,
                              re_mode=re_mode)
uploads = {type(m).__name__: 0 for m in _instances}
for m in _instances:
    uploads[type(m).__name__] += m.static_upload_count
with open(os.path.join(out_dir, f"metrics_{pid}.json"), "w") as f:
    json.dump({"metrics": metrics, "sharded_calls": sharded_calls,
               "static_uploads": uploads}, f)
print(f"proc {pid}: {metrics} (sharded calls: {sharded_calls})", flush=True)
