"""gdmix-tpu: a JAX generalized mixed-effect (GDMix-capability) training engine.

One JAX/XLA codebase providing blockwise coordinate descent over a global fixed-effect
model plus per-entity random-effect models, replacing the reference linkedin/gdmix
TF1 + scipy + Spark + Kubeflow stack. See DESIGN.md and SURVEY.md.
"""

__version__ = "0.1.0"

# Restore env-var authority over the jax platform selection. Some deployment
# images preload jax via sitecustomize and pin the platform list
# programmatically, which silently overrides JAX_PLATFORMS / JAX_ENABLE_X64 for
# every subprocess (e.g. jobs launched by workflow.distributed.execute_job_dag).
# If the user set those env vars, they win.
import os as _os  # noqa: E402

if "JAX_PLATFORMS" in _os.environ or "JAX_ENABLE_X64" in _os.environ:
    import jax as _jax  # noqa: E402

    if _os.environ.get("JAX_PLATFORMS"):
        _jax.config.update("jax_platforms", _os.environ["JAX_PLATFORMS"])
    if _os.environ.get("JAX_ENABLE_X64"):
        _jax.config.update(
            "jax_enable_x64",
            _os.environ["JAX_ENABLE_X64"].lower() in ("1", "true", "yes"))


def _host_fingerprint() -> str:
    """Short stable hash of this host's CPU feature set (platform.machine +
    /proc/cpuinfo flags) — partitions the default compile-cache dir per
    machine type."""
    import hashlib
    import platform
    sig = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    sig += line
                    break
    except OSError:
        pass
    return hashlib.sha256(sig.encode()).hexdigest()[:12]


def default_compile_cache_dir() -> str:
    """<checkout>/.jax_cache/xla-<host-cpu-hash>: a fixed path (the path is
    part of the cache key, so a moving directory never hits). The hash keeps
    machine-feature-specific XLA:CPU entries — which a device process also
    compiles for host-side jits — from crossing hosts, where loading them can
    crash the process."""
    checkout = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(checkout, ".jax_cache", f"xla-{_host_fingerprint()}")


def _enable_persistent_compile_cache() -> None:
    """Persistent XLA compilation cache, on by default off the CPU.

    A cold pipeline run is compile-bound, and GDMix's shapes repeat across
    runs (power-of-two bucket tiers, fixed FE padding policy), so a disk
    cache turns every rerun, sweep and retry into cache hits.

    - JAX_COMPILATION_CACHE_DIR set (jax reads it itself): that directory is
      used and nothing here changes it.
    - otherwise, unless the platform list names only the CPU (whose test
      runs compile thousands of small programs not worth caching), the cache
      lives at default_compile_cache_dir().
    - GDMIX_TPU_COMPILE_CACHE=off (or 0/false/no) disables the default.
    """
    raw = _os.environ.get("GDMIX_TPU_COMPILE_CACHE", "")
    if raw.lower() in ("0", "off", "false", "no"):
        return
    import jax as _jax  # noqa: E402

    if _jax.config.jax_compilation_cache_dir:  # user already configured one
        return
    platforms = str(_jax.config.jax_platforms or "").lower()
    if platforms and set(platforms.split(",")) <= {"cpu"}:
        return
    path = default_compile_cache_dir()
    try:
        _os.makedirs(path, exist_ok=True)
    except OSError:
        return  # read-only checkout: run uncached rather than fail the import
    _jax.config.update("jax_compilation_cache_dir", path)
    # keep a small floor so trivial host-side jits don't churn inodes
    # (an explicit JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS still wins)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in _os.environ:
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)


def _tune_host_allocator() -> None:
    """Disable numpy's MADV_HUGEPAGE on large buffers.

    On kernels with THP `defrag=madvise`, every madvised
    first touch triggers synchronous compaction: measured 19.5 s vs 0.17 s to
    fill a fresh 320 MB array (115x). The host data path (decode, grouping,
    bucketizing, score marshaling) allocates large fresh buffers constantly,
    so those stalls dominate cold-run wall clock; the TLB wins from hugepages
    are negligible for streaming passes. GDMIX_TPU_HUGEPAGE_MADVISE=1
    restores numpy's default. Uses numpy's runtime switch because the
    NUMPY_MADVISE_HUGEPAGE env var is read at import time, and a
    sitecustomize may import numpy before user code runs.
    """
    if _os.environ.get("GDMIX_TPU_HUGEPAGE_MADVISE", "").lower() in (
            "1", "on", "true", "yes"):
        return
    try:
        from numpy._core import multiarray  # numpy >= 2
    except ImportError:  # pragma: no cover - numpy < 2
        try:
            from numpy.core import multiarray
        except ImportError:
            return
    try:
        multiarray._set_madvise_hugepage(False)
    except Exception:  # pragma: no cover - private API drift
        pass


_enable_persistent_compile_cache()
_tune_host_allocator()
