"""Timing / profiling / memory instrumentation.

The reference's observability is wall-clock log lines per phase plus psutil RSS
per L-BFGS funcall (SURVEY.md §5). This module provides the same surface —
`phase(...)` context timers with RSS deltas — plus what the JAX stack adds for
free: `device_profile(...)` wraps a block in a jax.profiler trace (set
GDMIX_TPU_PROFILE=/dir or pass log_dir) viewable in XProf/TensorBoard.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

logger = logging.getLogger(__name__)


def rss_gb() -> float:
    """Resident set size in GB (psutil if present, /proc fallback)."""
    try:
        import psutil
        return psutil.Process(os.getpid()).memory_info().rss / 1e9
    except ImportError:
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
        except OSError:
            return float("nan")


@contextlib.contextmanager
def phase(name: str, log=logger) -> Iterator[None]:
    """Wall-clock + RSS phase timer (the reference's per-phase log lines)."""
    t0 = time.time()
    r0 = rss_gb()
    try:
        yield
    finally:
        log.info("%s --- %.3f seconds --- memory used: %.2f GB (Δ%+.2f)",
                 name, time.time() - t0, rss_gb(), rss_gb() - r0)


@contextlib.contextmanager
def device_profile(log_dir: Optional[str] = None) -> Iterator[None]:
    """jax.profiler trace around a block. Active when log_dir is given or
    GDMIX_TPU_PROFILE is set; no-op otherwise."""
    log_dir = log_dir or os.environ.get("GDMIX_TPU_PROFILE")
    if not log_dir:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("Wrote device trace to %s", log_dir)


import functools


@functools.lru_cache(maxsize=None)
def measure_dispatch_latency_s() -> float:
    """One-time per-process probe of the device dispatch round trip: wall of
    a tiny jitted call + scalar fetch, min of 3 after a warmup compile.
    Feeds the lane-bucket packing decision (data/bucketing.plan_lane_buckets),
    whose outcome depends on what one extra dispatch costs on this host.
    Its value on the H100 host is not measured yet."""
    import jax
    import jax.numpy as jnp
    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros(())
    float(f(x))  # compile + warm
    ts = []
    for _ in range(3):
        t0 = time.time()
        float(f(x))
        ts.append(time.time() - t0)
    lat = min(ts)
    logger.info("measured dispatch latency: %.3f ms", lat * 1e3)
    return lat


def nominal_dispatch_latency_s() -> float:
    """The measured dispatch latency CLASSIFIED to a stable nominal value:
    25 ms for a remote-attached device (≥ 5 ms measured), else 1 ms (local
    dispatch plus the ~ms per-bucket host-marshal floor that rides every
    extra bucket). The bucket plan must not depend on run-to-run latency
    jitter — a plan that moved with it would thrash the compile cache — so
    the packing decision keys on the CLASS, not the sample."""
    lat = measure_dispatch_latency_s()
    return 25e-3 if lat >= 5e-3 else 1e-3
