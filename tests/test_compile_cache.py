"""Persistent XLA compilation cache wiring (gdmix_tpu.__init__).

The reference has no analog (TF1 graphs rebuild per process); here a cold run
is compile-bound, so the package turns jax's persistent cache on by default
off the CPU, at a fixed directory inside the checkout. JAX_COMPILATION_CACHE_DIR
always wins; GDMIX_TPU_COMPILE_CACHE=off disables the default. The probes only
read jax's config, so naming a GPU platform needs no GPU.
"""
import os
import subprocess
import sys

import gdmix_tpu

_PROBE = ("import gdmix_tpu, jax; "
          "print('CACHE=%s' % jax.config.jax_compilation_cache_dir)")


def _probe(tmp_path, **env_overrides):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("GDMIX_TPU_COMPILE_CACHE", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_overrides)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_cpu_default_is_disabled(tmp_path):
    assert _probe(tmp_path) == "CACHE=None"


def test_explicit_path_enables_on_cpu(tmp_path):
    d = str(tmp_path / "xla")
    assert _probe(tmp_path, JAX_COMPILATION_CACHE_DIR=d) == f"CACHE={d}"


def test_off_values_disable(tmp_path):
    for off in ("0", "off"):
        assert _probe(tmp_path, JAX_PLATFORMS="cuda",
                      GDMIX_TPU_COMPILE_CACHE=off) == "CACHE=None"


def test_existing_jax_setting_wins(tmp_path):
    d = str(tmp_path / "theirs")
    got = _probe(tmp_path, JAX_PLATFORMS="cuda", JAX_COMPILATION_CACHE_DIR=d)
    assert got == f"CACHE={d}"


def test_default_is_fixed_dir_in_checkout(tmp_path):
    """Off the CPU the default is <checkout>/.jax_cache/xla-<host hash>,
    the same path in every process."""
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        gdmix_tpu.__file__)))
    want = gdmix_tpu.default_compile_cache_dir()
    assert os.path.dirname(want) == os.path.join(checkout, ".jax_cache")
    assert _probe(tmp_path, JAX_PLATFORMS="cuda") == f"CACHE={want}"
    assert _probe(tmp_path, JAX_PLATFORMS="cuda,cpu") == f"CACHE={want}"
    assert os.path.isdir(want)


def test_env_dir_wins_over_default_off_cpu(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the package configures no other
    directory (and so never creates its default one for this process)."""
    d = str(tmp_path / "env")
    out = subprocess.run(
        [sys.executable, "-c",
         "import gdmix_tpu, jax; print(jax.config.jax_compilation_cache_dir,"
         " jax.config.jax_persistent_cache_min_compile_time_secs)"],
        env=dict(os.environ, JAX_PLATFORMS="cuda",
                 JAX_COMPILATION_CACHE_DIR=d),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    cache_dir, min_secs = out.stdout.split()
    assert cache_dir == d
    assert float(min_secs) == 1.0   # jax's own default, untouched


def test_cache_populates_and_run_matches(tmp_path):
    """Two fresh processes: the second must produce identical output with the
    cache directory populated by the first."""
    d = str(tmp_path / "xla")
    prog = ("import gdmix_tpu, jax, jax.numpy as jnp; "
            "print(jax.jit(lambda x: (x @ x.T).sum())"
            "(jnp.arange(64.0).reshape(8, 8)))")
    outs = []
    for _ in range(2):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR=d,
                   JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
        r = subprocess.run([sys.executable, "-c", prog], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.strip())
    assert outs[0] == outs[1]
    assert os.listdir(d), "cache directory should hold at least one entry"
