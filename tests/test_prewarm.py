"""Tier-ladder prewarm tool: compiles the sharded RE plane's shape ladder
into the persistent XLA cache ahead of the first production dispatch. Runs in
subprocesses because jax pins the persistent cache dir at first use."""
import os
import subprocess
import sys

import pytest


def _run(cache, extra):
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_COMPILATION_CACHE_DIR=cache,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    out = subprocess.run(
        [sys.executable, "-m", "gdmix_tpu.tools.prewarm",
         "--tiers", "8,16", "--entities_per_tier", "24",
         "--support", "8", "--num_features", "300"] + extra,
        env=env, capture_output=True, timeout=480)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    return out.stderr.decode()


@pytest.mark.parametrize("host_plane", [False, True])
def test_prewarm_populates_persistent_cache(tmp_path, host_plane):
    cache = str(tmp_path / "xla")
    os.makedirs(cache)
    _run(cache, ["--host_plane"] if host_plane else [])
    entries = [f for f in os.listdir(cache) if not f.startswith(".")]
    assert entries, "prewarm wrote nothing to the persistent cache"


def test_prewarmed_second_process_is_compile_free(tmp_path):
    """The point of the tool: a SECOND cold process over the same shapes
    hits the persistent cache for every ladder computation (cache hits
    logged; and it runs measurably without recompiling — every persistent
    lookup that happens must be a hit, none a miss-then-write)."""
    cache = str(tmp_path / "xla")
    os.makedirs(cache)
    _run(cache, [])
    n_entries = len(os.listdir(cache))
    assert n_entries
    log = _run(cache, [])          # fresh process, same shapes
    # no new cache entries were written on the second run
    assert len(os.listdir(cache)) == n_entries, \
        "second run recompiled (new persistent-cache entries)"
