"""Device mesh + sharding helpers.

The device replacement for the reference's TF_CONFIG cluster plumbing
(/root/reference/gdmix-trainer/src/gdmix/drivers/fixed_effect_driver.py:24-58):
one 1-D "data" mesh over all devices. Fixed-effect batches shard along it
(XLA inserts the all-reduces that replace the gRPC ring collective);
random-effect coefficient tables row-shard along the same axis.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def get_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (DATA_AXIS,))


def local_mesh() -> Mesh:
    """Process-LOCAL 1-D mesh (this host's devices only). Under multi-host
    the random-effect plane composes two levels — interconnect routing within each
    process's local mesh × round-robin entity ownership + model-file exchange
    across processes (≡ the reference's partitions-across-workers × pool-
    within-worker, random_effect_lr_lbfgs_model.py:82-217) — so its
    collectives must stay inside the process."""
    return Mesh(np.array(jax.local_devices()), (DATA_AXIS,))


def batch_sharding(mesh: Mesh, rank: int = 1, batch_dim: int = 0) -> NamedSharding:
    """Shard `batch_dim` of a rank-`rank` array along the data axis."""
    spec = [None] * rank
    spec[batch_dim] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def sum_over_rows(mesh: Mesh, fn, shared, rows):
    """Run `fn(shared, rows) -> (summed, per_row)` on each device's own rows
    and sum `summed` over the devices (one psum).

    `shared` is passed whole to every device; `rows` is a pytree whose leaves all carry the batch on dim 0, split over
    the data axis; `per_row` comes back split the same way. A chunked scan
    over a sharded batch cannot be partitioned by XLA, which instead gathers
    the whole batch to every device and runs every chunk there; here each
    device scans only its own chunks. On a one-device mesh `fn` runs as is.
    The row count must divide by the mesh size (ops/logistic.pad_rows)."""
    if mesh.devices.size == 1:
        return fn(shared, rows)

    def local(sh, r):
        summed, per_row = fn(sh, r)
        return jax.lax.psum(summed, DATA_AXIS), per_row

    # check_vma off: the ops' scans start their carries from unvarying zeros
    return shard_map(local, mesh=mesh, in_specs=(P(), P(DATA_AXIS)),
                     out_specs=(P(), P(DATA_AXIS)),
                     check_vma=False)(shared, rows)
