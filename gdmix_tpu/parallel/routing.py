"""All-to-all example routing: send each record to the shard owning its entity.

The interconnect replacement for Spark's shuffle-by-entity (SURVEY.md §5-comm): the
random-effect coefficient table is row-sharded over the mesh, so examples must
move to the chip holding their entity's coefficients. Implemented as the
standard fixed-capacity exchange (MoE-style): each shard sorts its records by
destination, packs them into [P, C] capacity-padded slots, and one
`jax.lax.all_to_all` delivers every slot — O(N/P) per link, over the device
interconnect.

Capacity C is static (XLA needs static shapes); records beyond a destination's
capacity are dropped and reported via the per-shard overflow count, so callers
size C with headroom (or re-route the remainder in a second pass).

Production caller: parallel/entity_sharding.route_and_bucket (used by
RandomEffectLRModel.fit_records_sharded and the in-HBM pipeline's sharded RE
mode), which plans C exactly on host and asserts zero overflow.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


class Routed(NamedTuple):
    arrays: Dict[str, jnp.ndarray]   # [P*C, ...] per shard (global: sharded dim 0)
    valid: jnp.ndarray               # [P*C] bool per shard
    overflow: jnp.ndarray            # [1] per shard: records dropped at send


def _route_local(arrays: Dict[str, jnp.ndarray], target: jnp.ndarray,
                 num_shards: int, capacity: int, axis: str):
    """Runs per shard under shard_map."""
    n = target.shape[0]
    order = jnp.argsort(target, stable=True)
    t_sorted = target[order]
    # position of each sorted record within its destination group
    idx = jnp.arange(n)
    first_of_dest = jnp.searchsorted(t_sorted, jnp.arange(num_shards))
    rank_in_dest = idx - first_of_dest[t_sorted]
    keep = rank_in_dest < capacity
    # overflow records scatter into a trash slot past the packed area so they
    # can never clobber a legitimately-kept record
    slot = jnp.where(keep, t_sorted * capacity + rank_in_dest,
                     num_shards * capacity)

    def pack(a):
        a_sorted = a[order]
        shape = (num_shards * capacity + 1,) + a.shape[1:]
        packed = jnp.zeros(shape, a.dtype)
        return packed.at[slot].set(a_sorted)[:-1]

    packed = {k: pack(v) for k, v in arrays.items()}
    valid = jnp.zeros((num_shards * capacity + 1,), bool).at[slot].set(
        keep)[:-1]
    overflow = jnp.sum(~keep)

    def exchange(a):
        blocks = a.reshape((num_shards, capacity) + a.shape[1:])
        # shard i sends blocks[j] to shard j; receives shard j's block i
        recv = jax.lax.all_to_all(blocks, axis, split_axis=0, concat_axis=0)
        return recv.reshape((num_shards * capacity,) + blocks.shape[2:])

    out = {k: exchange(v) for k, v in packed.items()}
    valid_out = exchange(valid)
    return out, valid_out, overflow[None]


def route_to_entity_shards(mesh: Mesh, arrays: Dict[str, jnp.ndarray],
                           target_shard: jnp.ndarray, capacity: int,
                           axis: str = "data") -> Routed:
    """Route records (dim 0 sharded over `axis`) to their target shards.

    arrays: {name: [N_global, ...]} sharded on dim 0; target_shard [N_global]
    in [0, P). Returns per-shard [P·C]-slot arrays (again sharded on dim 0
    globally) plus validity mask and overflow counts.
    """
    num_shards = mesh.shape[axis]
    in_specs = ({k: P(axis) for k in arrays}, P(axis))
    out_specs = ({k: P(axis) for k in arrays}, P(axis), P(axis))
    fn = shard_map(
        partial(_route_local, num_shards=num_shards, capacity=capacity,
                axis=axis),
        mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    out, valid, overflow = fn(arrays, target_shard)
    return Routed(arrays=out, valid=valid, overflow=overflow)
