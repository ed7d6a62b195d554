"""Multi-chip random-effect data plane: shuffle-by-entity over the
device interconnect.

The SPMD equivalent of the reference's Spark shuffle + partition assignment
(/root/reference/gdmix-data/src/main/scala/com/linkedin/gdmix/data/
DataPartitioner.scala:235-276 routes records to the partition owning their
entity; /root/reference/gdmix-trainer/src/gdmix/drivers/random_effect_driver.py:
60-68 assigns partitions to workers): every record moves — in one
`jax.lax.all_to_all` — to the mesh shard that owns its entity's coefficient
row, where it is grouped and packed into dense vmapped-solver blocks, entirely
on device. Production caller: RandomEffectLRModel.fit_records_sharded.

Pipeline (one jit, two shard_map stages):
  1. routing.route_to_entity_shards — fixed-capacity all-to-all exchange
  2. segment.build_entity_blocks    — per-shard sort-by-entity + block packing

The returned block arrays are globally [P·b_cap, n_cap, ...] with the entity
axis sharded over the mesh: the batched Newton/L-BFGS solver then runs each
shard's entities on its own chip (GSPMD, no further communication).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gdmix_tpu.ops.segment import build_entity_blocks
from gdmix_tpu.parallel.mesh import DATA_AXIS, pad_to_multiple
from gdmix_tpu.parallel.routing import route_to_entity_shards


class ShardedBlocks(NamedTuple):
    blocks: Dict[str, jnp.ndarray]   # [P·b_cap, n_cap, ...] entity-axis sharded
    slot_entity: jnp.ndarray         # [P·b_cap] global entity index (-1 empty)
    slot_count: jnp.ndarray          # [P·b_cap] records packed per slot
    dropped: jnp.ndarray             # [2·P] records lost to capacity (route, pack)


@functools.lru_cache(maxsize=None)
def _route_fn(mesh: Mesh, capacity: int, axis: str, keys: tuple):
    def fn(arrays, owner):
        r = route_to_entity_shards(mesh, arrays, owner, capacity, axis)
        return r.arrays, r.valid, r.overflow
    return jax.jit(fn)


def route_records(mesh: Mesh, arrays: Dict[str, jnp.ndarray],
                  owner: jnp.ndarray, *, capacity: int, axis: str = DATA_AXIS):
    """One fixed-capacity all-to-all delivering ALL payload columns to their
    entity-owner shards; per-tier packing (pack_tier) then reuses the routed
    arrays without re-routing. Returns a routing.Routed."""
    from gdmix_tpu.parallel.routing import Routed
    fn = _route_fn(mesh, capacity, axis, tuple(sorted(arrays)))
    out, valid, overflow = fn(arrays, owner.astype(jnp.int32))
    return Routed(arrays=out, valid=valid, overflow=overflow)


@functools.lru_cache(maxsize=None)
def _pack_tier_fn(mesh: Mesh, b_cap: int, n_cap: int, axis: str, keys: tuple):
    def fn(payload, valid, ent, tier_col, t):
        def bucket_local(r_arrays, r_valid, r_ent, r_tier, tt):
            v = r_valid & (r_tier == tt)
            blocks, slot_entity, slot_count, dropped = build_entity_blocks(
                r_ent, r_arrays, v, b_cap, n_cap)
            return blocks, slot_entity, slot_count, dropped[None]
        fn2 = shard_map(
            bucket_local, mesh=mesh,
            in_specs=({k: P(axis) for k in payload}, P(axis), P(axis),
                      P(axis), P()),
            out_specs=({k: P(axis) for k in payload}, P(axis), P(axis),
                       P(axis)))
        return fn2(payload, valid, ent, tier_col, t)
    return jax.jit(fn)


def pack_tier(mesh: Mesh, routed, ent: jnp.ndarray, tier_col: jnp.ndarray,
              t: int, *, b_cap: int, n_cap: int, axis: str = DATA_AXIS):
    """Pack ONE sample-count tier's routed records into [P·b_cap, n_cap, ...]
    solver blocks, on device (records of other tiers are masked to the entity
    sentinel and never enter a block). The tier index rides as a device scalar
    so tiers sharing (b_cap, n_cap) reuse one compiled computation.

    Returns (blocks, slot_entity, slot_count, dropped[P])."""
    payload = {k: v for k, v in routed.arrays.items()
               if k not in ("_ent", "_tier")}
    fn = _pack_tier_fn(mesh, b_cap, n_cap, axis, tuple(sorted(payload)))
    return fn(payload, routed.valid, ent, tier_col,
              jnp.asarray(t, jnp.int32))


@functools.lru_cache(maxsize=None)
def _route_and_bucket_fn(mesh: Mesh, capacity: int, b_cap: int, n_cap: int,
                         axis: str, keys: tuple):
    def fn(arrays: Dict[str, jnp.ndarray], owner: jnp.ndarray):
        routed = route_to_entity_shards(mesh, arrays, owner, capacity, axis)

        def bucket_local(r_arrays, r_valid):
            ent = r_arrays.pop("_ent")
            blocks, slot_entity, slot_count, dropped = build_entity_blocks(
                ent, r_arrays, r_valid, b_cap, n_cap)
            return blocks, slot_entity, slot_count, dropped[None]

        payload = {k: v for k, v in routed.arrays.items()}
        fn2 = shard_map(
            bucket_local, mesh=mesh,
            in_specs=({k: P(axis) for k in payload}, P(axis)),
            out_specs=({k: P(axis) for k in payload if k != "_ent"},
                       P(axis), P(axis), P(axis)))
        blocks, slot_entity, slot_count, pack_dropped = fn2(payload,
                                                            routed.valid)
        dropped = jnp.concatenate([routed.overflow, pack_dropped])
        return blocks, slot_entity, slot_count, dropped
    return jax.jit(fn)


def route_and_bucket(mesh: Mesh, arrays: Dict[str, jnp.ndarray],
                     ent_idx: jnp.ndarray, owner: jnp.ndarray, *,
                     capacity: int, b_cap: int, n_cap: int,
                     axis: str = DATA_AXIS) -> ShardedBlocks:
    """Route records (dim 0 sharded over `axis`) to their entity-owner shards
    and pack each shard's records into [b_cap, n_cap, ...] solver blocks.

    arrays:  {name: [N, ...]} record payloads, dim 0 sharded
    ent_idx: [N] int32 global entity index per record
    owner:   [N] int32 owning shard per record, in [0, P)
    """
    fn = _route_and_bucket_fn(mesh, capacity, b_cap, n_cap, axis,
                              tuple(sorted(arrays)))
    blocks, slot_entity, slot_count, dropped = fn(
        dict(arrays, _ent=ent_idx.astype(jnp.int32)), owner.astype(jnp.int32))
    return ShardedBlocks(blocks=blocks, slot_entity=slot_entity,
                         slot_count=slot_count, dropped=dropped)


def plan_capacities(owner_of_entity: np.ndarray, ent_idx: np.ndarray,
                    num_shards: int, rows_per_shard: int):
    """Host-side exact capacity planning for the fixed-capacity exchange.

    Returns (capacity, b_cap, n_cap_min): the max records any source shard
    sends to any destination (rounded up ×8), the max entities owned by one
    shard (rounded up ×8), and the max records of any single entity.
    """
    owner = owner_of_entity[ent_idx]
    n = len(ent_idx)
    src = np.arange(n) // rows_per_shard
    pair_counts = np.bincount(src * num_shards + owner,
                              minlength=num_shards * num_shards)
    capacity = max(int(pair_counts.max()), 1)
    capacity = pad_to_multiple(capacity, 8)
    b_cap = max(int(np.bincount(owner_of_entity,
                                minlength=num_shards).max()), 1)
    b_cap = pad_to_multiple(b_cap, 8)
    n_cap_min = int(np.bincount(ent_idx).max())
    return capacity, b_cap, n_cap_min


def shard_rows(mesh: Mesh, a: np.ndarray, axis: str = DATA_AXIS):
    """device_put a host array with dim 0 sharded over the mesh."""
    spec = [None] * a.ndim
    spec[0] = axis
    return jax.device_put(a, NamedSharding(mesh, P(*spec)))
