"""Entity bucketing: ragged per-entity datasets → dense padded solver buckets.

The device replacement for the reference's producer/consumer job queue
(/root/reference/gdmix-trainer/src/gdmix/models/custom/scipy/job_consumers.py:161-296):
instead of slicing one scipy COO matrix per entity and queueing it to a process
pool, entities are grouped into a few power-of-two-sized buckets and solved as
vmapped batches.

Each entity's problem is expressed in COMPACT FEATURE SPACE: its records' global
feature ids are remapped onto [0, U) where U is the entity's unique-feature count
(padded per bucket). This is the reference's `enable_local_indexing` — which is
output-equivalent to global indexing because the L2 term is coordinate-separable,
so coefficients outside an entity's support stay exactly zero and are dropped from
the exported model either way (job_consumers.py:55-63 extracts support coefficients
in both modes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from gdmix_tpu.io.input_pipeline import EntityGroup
from gdmix_tpu.io.model_avro import SparseModel


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class EntityBucket:
    """A batch of same-shape per-entity problems (all arrays leading dim B)."""
    entity_ids: List[str]
    indices: np.ndarray        # [B, n_cap, K] int32 — LOCAL feature ids
    values: np.ndarray         # [B, n_cap, K] float
    offsets: np.ndarray        # [B, n_cap]
    labels: np.ndarray         # [B, n_cap]
    weights: np.ndarray        # [B, n_cap] (0.0 marks padding rows)
    uids: np.ndarray           # [B, n_cap] int64
    sample_count: np.ndarray   # [B] int32 — true per-entity record count
    unique_global_indices: np.ndarray  # [B, U] int64 (0-padded)
    u_count: np.ndarray        # [B] int32 — true unique-feature count
    theta0: np.ndarray         # [B, 1+U] or [B, U] — warm-start coefficients

    @property
    def batch(self) -> int:
        return len(self.entity_ids)

    @property
    def n_cap(self) -> int:
        return self.indices.shape[1]

    @property
    def u_cap(self) -> int:
        return self.unique_global_indices.shape[1]


class _Compact(NamedTuple):
    """One entity's data in compact feature space, flattened (no per-record
    python objects — a single searchsorted remaps every nnz entry at once)."""
    unique: np.ndarray       # sorted unique global feature ids
    flat_local: np.ndarray   # [total_nnz] local ids, record-major
    flat_vals: np.ndarray    # [total_nnz]
    rec_nnz: np.ndarray      # [n] per-record nnz


def _entity_compact(group: EntityGroup) -> _Compact:
    if group.padded_indices is not None:
        # padded-block fast path: one mask, zero per-record python
        rec_nnz = np.asarray(group.rec_nnz, np.int64)
        k = group.padded_indices.shape[1]
        valid = np.arange(k)[None, :] < rec_nnz[:, None]
        all_idx = group.padded_indices[valid].astype(np.int64)
        all_val = group.padded_values[valid]
    else:
        rec_nnz = np.asarray([len(r) for r in group.ragged_indices], np.int64)
        if rec_nnz.sum():
            all_idx = np.concatenate(group.ragged_indices)
            all_val = np.concatenate(group.ragged_values)
        else:
            all_idx = np.zeros(0, np.int64)
            all_val = np.zeros(0)
    unique = np.unique(all_idx) if all_idx.size else np.zeros(1, np.int64)
    flat_local = np.searchsorted(unique, all_idx).astype(np.int32)
    return _Compact(unique=unique, flat_local=flat_local, flat_vals=all_val,
                    rec_nnz=rec_nnz)


def _warm_start(unique: np.ndarray, prior: Optional[SparseModel],
                has_intercept: bool, u_cap: int) -> np.ndarray:
    """Reconcile a prior model onto the entity's current support
    (reference job_consumers.py:260-288)."""
    dim = u_cap + (1 if has_intercept else 0)
    theta0 = np.zeros(dim, dtype=np.float64)
    if prior is None:
        return theta0
    off = 1 if has_intercept else 0
    if has_intercept:
        theta0[0] = prior.theta[0]
    p_idx = np.asarray(prior.unique_global_indices)
    if p_idx.size:
        order = np.argsort(p_idx, kind="stable")
        p_sorted = p_idx[order]
        p_theta = np.asarray(prior.theta[off:])[order]
        pos = np.searchsorted(p_sorted, unique)
        pos_c = np.clip(pos, 0, len(p_sorted) - 1)
        hit = p_sorted[pos_c] == unique
        theta0[off:off + len(unique)][hit] = p_theta[pos_c[hit]]
    return theta0


@dataclass
class FlatGroups:
    """Columnar grouped dataset: every per-record column flat [N] in
    entity-major record order, entities delimited by `counts`. The zero-object
    twin of List[EntityGroup] — at production entity counts the per-entity
    python objects dominate the host wall clock, so the grouping and
    bucketizing hot paths stay in whole-array numpy ops end to end."""
    entity_ids: np.ndarray            # [E] str/object
    counts: np.ndarray                # [E] records per entity (all ≥ 1)
    columns: Dict[str, np.ndarray]    # flat [N] per-record columns
    indices: Optional[np.ndarray]     # [N, K] global feature ids (padded)
    values: Optional[np.ndarray]      # [N, K]
    rec_nnz: Optional[np.ndarray]     # [N]

    def __len__(self) -> int:
        return len(self.entity_ids)


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _zeros_touched(shape, dtype) -> np.ndarray:
    """np.zeros whose pages are faulted in sequentially.

    Buffers filled by random-order fancy scatter otherwise take one page
    fault per touch with no fault-around (seconds per 100 MB buffer on a
    host whose page faults are slow); a sequential fill(0) maps the same
    pages in one streaming pass."""
    a = np.empty(shape, dtype)
    a.fill(0)
    return a


def select_entities(fg: FlatGroups, idx) -> FlatGroups:
    """Columnar subset: the entities at positions `idx` (with their records),
    preserving order — the FlatGroups analog of list slicing (used for
    round-robin entity ownership across processes)."""
    idx = np.asarray(idx, np.int64)
    counts = np.asarray(fg.counts, np.int64)
    starts = np.cumsum(counts) - counts
    lens = counts[idx]
    total = int(lens.sum())
    off = np.cumsum(lens) - lens
    rec = np.repeat(starts[idx] - off, lens) + np.arange(total)
    return FlatGroups(
        entity_ids=np.asarray(fg.entity_ids, object)[idx],
        counts=lens,
        columns={k: v[rec] for k, v in fg.columns.items()},
        indices=None if fg.indices is None else fg.indices[rec],
        values=None if fg.values is None else fg.values[rec],
        rec_nnz=None if fg.rec_nnz is None else fg.rec_nnz[rec])


def _sample_caps(counts: np.ndarray, min_bucket_rows: int) -> List[int]:
    caps: List[int] = []
    cap = min_bucket_rows
    max_count = int(counts.max())
    while cap < max_count:
        caps.append(cap)
        cap *= 2
    caps.append(_round_up(max_count, min_bucket_rows))
    return caps


LANE_BLOCK = 128   # entity-block width of the packing cost model


# Modeled cost of promoting one row into a bigger tier (padded compute +
# iteration coupling), calibrated on an earlier accelerator (not yet measured
# on the GPU). Used ONLY to decide whether a merged dispatch saves more than
# its promoted rows cost.
PACK_PROMOTED_ROW_COST_S = 7.5e-7


def plan_lane_buckets(counts: np.ndarray, caps,
                      dispatch_latency_s: Optional[float] = None) -> List:
    """The bucket PLAN shared by both bucketizers: one bucket per pow-2
    sample-count tier, per-entity tier assignment — plus a HARDWARE-ADAPTIVE
    small-tier merge: with `dispatch_latency_s` given (one startup probe,
    util/timing.measure_dispatch_latency_s), a tier merges into the next
    whenever the dispatch it saves exceeds the modeled cost of its promoted
    rows (PACK_PROMOTED_ROW_COST_S). With a remote-attached device's ~25 ms
    dispatch only trivially small tiers merge; with a local ~1 ms dispatch
    packing happens only where the model says it wins.

    Cross-tier lane packing (promoting sorted 128-entity blocks to their max
    member's tier, and decomposing pow-2 batch padding into ceil-128 pieces)
    cuts modeled padded rows, but an earlier accelerator measured it slower
    end to end: every extra bucket costs a dispatch, and merging tiers
    couples the merged bucket's ITERATION count to its slowest members, so
    promoted small entities ride along for every extra iteration. Padded
    rows were cheap; dispatches and coupled iterations were not. So:
    per-entity tiers, one bucket per tier. Neither side is measured on the
    GPU yet.

    Returns [(n_cap, member_indices ndarray)] in ascending n_cap order —
    deterministic and identical for the object and columnar paths.
    DataPartitioner's max_samples bound tames the same tail in the
    reference (DataPartitioner.scala:332-379)."""
    counts = np.asarray(counts, np.int64)
    caps = np.asarray(caps, np.int64)
    tier = np.searchsorted(caps, counts, side="left")
    plan = [(int(caps[t]), np.flatnonzero(tier == t))
            for t in range(len(caps)) if (tier == t).any()]
    if dispatch_latency_s is None:
        return plan
    # 1) smallest-first adjacent merges while the saved dispatch beats the
    # modeled promoted-row cost (at a 25 ms dispatch this merges only tiers
    # whose promotion costs < ~33k row-slots; blanket promotion at ~100k+
    # rows/merge measured slower). Merging is transitive (a twice-promoted
    # tier pays the final cap).
    merged: List = []
    i = 0
    while i < len(plan):
        cap_i, members = plan[i]
        while i + 1 < len(plan):
            cap_j, members_j = plan[i + 1]
            promoted_rows = int(len(members)) * (cap_j - cap_i)
            if promoted_rows * PACK_PROMOTED_ROW_COST_S >= dispatch_latency_s:
                break
            members = np.concatenate([members, members_j])
            cap_i = cap_j
            i += 1
        merged.append((cap_i, np.sort(members)))
        i += 1
    # 2) pow-2 batch-padding decomposition — slower where a dispatch costs
    # 25 ms (+8 dispatches), a win where dispatch is cheap: split a tier's
    # batch into LANE_BLOCK-aligned pieces
    # when the padded lanes saved are worth more than the added dispatches.
    out: List = []
    for n_cap, members in merged:
        b = len(members)
        pow2_pad = _next_pow2(max(b, 1)) - b
        nblocks = (b + LANE_BLOCK - 1) // LANE_BLOCK
        rem = b - (nblocks - 1) * LANE_BLOCK
        dec_pad = _next_pow2(max(rem, 1)) - rem
        saved_rows = (pow2_pad - dec_pad) * n_cap
        if (nblocks > 1
                and saved_rows * PACK_PROMOTED_ROW_COST_S
                > (nblocks - 1) * dispatch_latency_s):
            for s in range(0, b, LANE_BLOCK):
                out.append((n_cap, members[s:s + LANE_BLOCK]))
        else:
            out.append((n_cap, members))
    return out


def bucketize_flat(fg: FlatGroups,
                   schema_params,
                   offset_column_name: str,
                   has_intercept: bool = True,
                   prior_models: Optional[Dict[str, SparseModel]] = None,
                   min_bucket_rows: int = 8,
                   batch_align: int = 8,
                   nnz_align: int = 4) -> List[EntityBucket]:
    """bucketize() on the columnar representation — identical buckets, no
    per-entity python. All compaction (per-entity unique features, local ids)
    runs as one global lexsort + segmented cumsum."""
    return list(iter_bucketize_flat(
        fg, schema_params, offset_column_name, has_intercept=has_intercept,
        prior_models=prior_models, min_bucket_rows=min_bucket_rows,
        batch_align=batch_align, nnz_align=nnz_align))


def iter_bucketize_flat(fg: FlatGroups,
                        schema_params,
                        offset_column_name: str,
                        has_intercept: bool = True,
                        prior_models: Optional[Dict[str, SparseModel]] = None,
                        min_bucket_rows: int = 8,
                        batch_align: int = 8,
                        nnz_align: int = 4):
    """Generator form of bucketize_flat: yields each tier's EntityBucket as
    soon as it is marshaled, so a caller can dispatch tier t's device solve
    while tier t+1 is still being built on the host (fit_groups pipelines the
    RE stage this way — the device is busy during ~all of the host marshal)."""
    E = len(fg.entity_ids)
    if E == 0:
        return
    prior_models = prior_models or {}
    counts = np.asarray(fg.counts, np.int64)
    # zero-record entities are legal (the object path buckets them as
    # instantly-converged zero-weight lanes); all the gathers below mask by
    # validrow, so they just contribute empty rows
    N = int(counts.sum())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ent_of_rec = np.repeat(np.arange(E), counts)

    # ---- per-entity unique features + local nnz ids, globally vectorized ----
    local2d = None   # [N, K] per-entry local ids (native fast path)
    if fg.indices is not None:
        K = fg.indices.shape[1]
        rec_nnz = (np.asarray(fg.rec_nnz, np.int64) if fg.rec_nnz is not None
                   else np.full(N, K, np.int64))
        from gdmix_tpu import native as _native
        nat = _native.entry_local(fg.indices, fg.values, fg.rec_nnz, counts,
                                  starts)
        if nat is not None:
            # multicore C++: per-entity sort+dedup (records are entity-
            # contiguous in FlatGroups, so no global argsort is needed)
            local2d, uniq_fid, u_counts, u_offs_full = nat
            u_off = u_offs_full[:-1]
            uniq_ent = np.repeat(np.arange(E), u_counts)
            flat_ent = flat_rec = flat_col = flat_val = local = None
        else:
            valid = np.arange(K)[None, :] < rec_nnz[:, None]      # [N, K]
            # one flatnonzero + five M-sized gathers instead of five [N, K]
            # boolean extractions (each extraction rescans the mask)
            flat_pos = np.flatnonzero(valid.ravel())              # [M]
            flat_rec = flat_pos // K
            flat_col = flat_pos - flat_rec * K
            flat_ent = ent_of_rec[flat_rec]
            flat_fid = fg.indices.ravel()[flat_pos].astype(np.int64)
            flat_val = fg.values.ravel()[flat_pos]
            # entries are entity-contiguous, so one combined-key argsort
            # replaces the 2-key lexsort; ties (duplicate (entity, fid)) need
            # no stability
            fid_span = int(flat_fid.max()) + 1 if flat_fid.size else 1
            if E * fid_span < (1 << 62):
                order = np.argsort(flat_ent * fid_span + flat_fid)
            else:  # combined key would overflow int64 → 2-key lexsort
                order = np.lexsort((flat_fid, flat_ent))
            s_ent = flat_ent[order]
            s_fid = flat_fid[order]
            first = np.ones(len(order), bool)
            if len(order) > 1:
                first[1:] = (s_fid[1:] != s_fid[:-1]) \
                    | (s_ent[1:] != s_ent[:-1])
            uniq_slot = np.cumsum(first) - 1                      # [M]
            uniq_ent = s_ent[first]
            uniq_fid = s_fid[first]
            u_counts = np.bincount(uniq_ent, minlength=E)         # [E]
            u_off = np.concatenate([[0], np.cumsum(u_counts)[:-1]])
            local_sorted = uniq_slot - u_off[s_ent]
            local = np.empty(len(order), np.int64)
            local[order] = local_sorted                           # entry-order
        ent_max_nnz = np.zeros(E, np.int64)
        np.maximum.at(ent_max_nnz, ent_of_rec, rec_nnz)
    else:
        K = 0
        u_counts = np.zeros(E, np.int64)
        u_off = np.zeros(E, np.int64)
        uniq_fid = np.zeros(0, np.int64)
        uniq_ent = np.zeros(0, np.int64)
        ent_max_nnz = np.zeros(E, np.int64)
        flat_ent = flat_rec = flat_col = flat_fid = flat_val = local = \
            np.zeros(0, np.int64)
    # zero-nnz entities carry unique=[0], u_count=1 (matches _entity_compact)
    u_eff = np.maximum(u_counts, 1)

    label_col = schema_params.label_column_name
    weight_col = schema_params.weight_column_name
    uid_col = schema_params.uid_column_name
    caps = np.asarray(_sample_caps(counts, min_bucket_rows))
    from gdmix_tpu.util.timing import nominal_dispatch_latency_s
    plan = plan_lane_buckets(counts, caps,
                             dispatch_latency_s=nominal_dispatch_latency_s())
    bucket_of = np.empty(E, np.int64)                             # [E]
    for bi, (_, members_) in enumerate(plan):
        bucket_of[members_] = bi

    # Vectorized warm-start reconciliation (job_consumers.py:260-288) when the
    # prior is a columnar ModelTable: intersect every entity's prior support
    # with its current support in one searchsorted instead of per-entity
    # python. Produces flat (entity, local_pos, value) scatter triples.
    warm = None
    from gdmix_tpu.io.model_table import (ModelTable, flat_positions,
                                          intersect_prior_support)
    eids_arr = np.asarray(fg.entity_ids, dtype=object)
    if (isinstance(prior_models, ModelTable) and len(prior_models)
            and prior_models.has_intercept == has_intercept):
        id2row = prior_models.id2row
        prow = np.fromiter((id2row.get(e, -1) for e in eids_arr), np.int64, E)
        hasp = prow >= 0
        ents = np.flatnonzero(hasp)
        fid_hi = max(int(prior_models.coef_ids.max(initial=0)),
                     int(uniq_fid.max(initial=0))) + 1
        if E * fid_hi >= (1 << 62):
            # the whole-table max can be inflated by prior rows that are not
            # even in this FlatGroups (e.g. another partition's feature space);
            # recompute over the MATCHED rows only before giving up on the
            # vectorized path
            lens_m = prior_models.lens[prow[ents]]
            src_m = flat_positions(prior_models.offs[prow[ents]], lens_m)
            fid_hi = max(int(prior_models.coef_ids[src_m].max(initial=0)),
                         int(uniq_fid.max(initial=0))) + 1
        if E * fid_hi < (1 << 62):  # else: combined key would overflow int64
            sup_keys = uniq_ent * fid_hi + uniq_fid    # sorted (entity-major)
            p_ent, p_fid, p_val, pos_c, hit = intersect_prior_support(
                prior_models, ents, prow[ents], sup_keys, fid_hi)
            warm_ent = p_ent[hit]
            warm_local = pos_c[hit] - u_off[warm_ent]
            warm_val = p_val[hit]
            # zero-nnz entities carry the dummy support [0] (object-path
            # parity): a prior coefficient for feature 0 lands at local 0
            z = (p_fid == 0) & (u_counts[p_ent] == 0)
            if z.any():
                warm_ent = np.concatenate([warm_ent, p_ent[z]])
                warm_local = np.concatenate(
                    [warm_local, np.zeros(int(z.sum()), np.int64)])
                warm_val = np.concatenate([warm_val, p_val[z]])
            warm = (warm_ent, warm_local, warm_val, hasp, prow)

    entry_bucket = (bucket_of[flat_ent]
                    if flat_ent is not None and len(flat_ent) else flat_ent)

    def _build_tier(bi: int) -> Optional[EntityBucket]:
        n_cap, members = plan[bi]
        if members.size == 0:
            return None
        b_real = members.size
        b = max(batch_align, _next_pow2(b_real))
        k = max(int(ent_max_nnz[members].max()), 1)
        k = _round_up(k, nnz_align)
        u = int(u_eff[members].max())
        u = _round_up(u, 8)
        dim = u + (1 if has_intercept else 0)

        slot_of = np.full(E, -1, np.int64)
        slot_of[members] = np.arange(b_real)
        m_counts = counts[members]
        m_starts = starts[members]

        # padded per-record gather [b_real, n_cap]
        rowpos = np.arange(n_cap)[None, :]
        validrow = rowpos < m_counts[:, None]
        gather = np.minimum(m_starts[:, None] + rowpos, N - 1)

        def pad_col(name, default=0.0, fallback_ones=False):
            out = np.zeros((b, n_cap), np.float64)
            if name and name in fg.columns:
                out[:b_real] = np.where(
                    validrow, fg.columns[name][gather].astype(np.float64), 0.0)
            elif fallback_ones:
                out[:b_real] = validrow.astype(np.float64)
            return out

        labels = pad_col(label_col)
        weights = pad_col(weight_col, fallback_ones=True)
        offsets = pad_col(offset_column_name)
        uids = np.zeros((b, n_cap), np.int64)
        if uid_col and uid_col in fg.columns:
            uids[:b_real] = np.where(
                validrow, fg.columns[uid_col][gather].astype(np.int64), 0)

        sample_count = np.zeros((b,), np.int32)
        sample_count[:b_real] = m_counts
        u_count = np.zeros((b,), np.int32)
        u_count[:b_real] = u_eff[members]
        unique_g = _zeros_touched((b, u), np.int64)
        if len(uniq_fid):
            # scatter each member's sorted unique fids into its row
            sel = np.flatnonzero(bucket_of[uniq_ent] == bi)
            unique_g[slot_of[uniq_ent[sel]],
                     (np.arange(len(uniq_ent)) - u_off[uniq_ent])[sel]] = \
                uniq_fid[sel]

        indices = _zeros_touched((b, n_cap, k), np.int32)
        values = _zeros_touched((b, n_cap, k), np.float64)
        if local2d is not None:
            from gdmix_tpu import native as _native
            _native.scatter_entries(fg.indices, fg.values, fg.rec_nnz,
                                    local2d, ent_of_rec, starts,
                                    bucket_of.astype(np.int32), slot_of, bi,
                                    indices, values)
        elif flat_ent is not None and len(flat_ent):
            esel = np.flatnonzero(entry_bucket == bi)
            if esel.size:
                e_ent = flat_ent[esel]
                indices[slot_of[e_ent],
                        flat_rec[esel] - starts[e_ent],
                        flat_col[esel]] = local[esel]
                values[slot_of[e_ent],
                       flat_rec[esel] - starts[e_ent],
                       flat_col[esel]] = flat_val[esel]

        theta0 = np.zeros((b, dim), np.float64)
        off_i = 1 if has_intercept else 0
        if warm is not None:
            warm_ent, warm_local, warm_val, hasp, prow = warm
            if has_intercept:
                wm = members[hasp[members]]
                theta0[slot_of[wm], 0] = prior_models.icpt[prow[wm]]
            wsel = np.flatnonzero(bucket_of[warm_ent] == bi)
            theta0[slot_of[warm_ent[wsel]],
                   off_i + warm_local[wsel]] = warm_val[wsel]
        elif prior_models:
            for slot, gi in enumerate(members):
                prior = prior_models.get(eids_arr[gi])
                if prior is None:
                    continue
                uq = (uniq_fid[u_off[gi]:u_off[gi] + u_counts[gi]]
                      if u_counts[gi] else np.zeros(1, np.int64))
                theta0[slot] = _warm_start(uq, prior, has_intercept, u)

        return EntityBucket(
            entity_ids=list(eids_arr[members]), indices=indices, values=values,
            offsets=offsets, labels=labels, weights=weights, uids=uids,
            sample_count=sample_count, unique_global_indices=unique_g,
            u_count=u_count, theta0=theta0)

    # Marshal tiers on a small thread pool (the big numpy fills/gathers/
    # scatters release the GIL) and yield in tier order as each completes —
    # callers can dispatch tier t's device solve while later tiers are still
    # being built.
    from concurrent.futures import ThreadPoolExecutor
    live = [bi for bi in range(len(plan))]
    if len(live) <= 1:
        for bi in live:
            bucket = _build_tier(bi)
            if bucket is not None:
                yield bucket
        return
    with ThreadPoolExecutor(max_workers=min(4, len(live))) as ex:
        futures = [ex.submit(_build_tier, bi) for bi in live]
        for fut in futures:
            bucket = fut.result()
            if bucket is not None:
                yield bucket


def bucketize(groups: Sequence[EntityGroup],
              schema_params,
              offset_column_name: str,
              has_intercept: bool = True,
              prior_models: Optional[Dict[str, SparseModel]] = None,
              min_bucket_rows: int = 8,
              batch_align: int = 8,
              nnz_align: int = 4) -> List[EntityBucket]:
    """Group entities into power-of-two sample-count buckets and pad.

    Padding entities (to align the batch dim) carry sample_count 0 / weights 0 and
    converge instantly in the batched solver.
    """
    if not groups:
        return []
    prior_models = prior_models or {}
    label_col = schema_params.label_column_name
    weight_col = schema_params.weight_column_name
    uid_col = schema_params.uid_column_name

    compact = [_entity_compact(g) for g in groups]
    counts = np.array([g.sample_count for g in groups])

    # Power-of-two caps starting at min_bucket_rows.
    caps: List[int] = []
    cap = min_bucket_rows
    max_count = int(counts.max())
    while cap < max_count:
        caps.append(cap)
        cap *= 2
    caps.append(_round_up(max_count, min_bucket_rows))

    # identical plan to iter_bucketize_flat (per-tier buckets + the
    # latency-classified small-tier merge, see plan_lane_buckets) — the
    # two paths must produce identical buckets
    from gdmix_tpu.util.timing import nominal_dispatch_latency_s
    plan = plan_lane_buckets(counts, caps,
                             dispatch_latency_s=nominal_dispatch_latency_s())

    buckets: List[EntityBucket] = []
    for n_cap, members in plan:
        b_real = len(members)
        # power-of-two batch tiers: far fewer distinct compiled shapes across
        # coordinates/datasets (each new shape is a jit compile)
        b = max(batch_align, _next_pow2(b_real))
        k = max(max((int(compact[gi].rec_nnz.max()) if compact[gi].rec_nnz.size
                     else 1 for gi in members)), 1)
        k = _round_up(k, nnz_align)
        u = max(max(len(compact[gi].unique) for gi in members), 1)
        u = _round_up(u, 8)
        dim = u + (1 if has_intercept else 0)

        indices = np.zeros((b, n_cap, k), dtype=np.int32)
        values = np.zeros((b, n_cap, k), dtype=np.float64)
        offsets = np.zeros((b, n_cap), dtype=np.float64)
        labels = np.zeros((b, n_cap), dtype=np.float64)
        weights = np.zeros((b, n_cap), dtype=np.float64)
        uids = np.zeros((b, n_cap), dtype=np.int64)
        sample_count = np.zeros((b,), dtype=np.int32)
        unique_g = np.zeros((b, u), dtype=np.int64)
        u_count = np.zeros((b,), dtype=np.int32)
        theta0 = np.zeros((b, dim), dtype=np.float64)
        entity_ids: List[str] = []

        for slot, gi in enumerate(members):
            g = groups[gi]
            c = compact[gi]
            n = g.sample_count
            entity_ids.append(g.entity_id)
            sample_count[slot] = n
            u_count[slot] = len(c.unique)
            unique_g[slot, :len(c.unique)] = c.unique
            if c.flat_local.size:
                # flat scatter of every nnz entry at once (record-major):
                # row r repeated nnz_r times, column = position within record
                rows = np.repeat(np.arange(len(c.rec_nnz)), c.rec_nnz)
                starts = np.concatenate([[0], np.cumsum(c.rec_nnz)[:-1]])
                cols = (np.arange(c.flat_local.size)
                        - np.repeat(starts, c.rec_nnz))
                indices[slot, rows, cols] = c.flat_local
                values[slot, rows, cols] = c.flat_vals
            if label_col and label_col in g.columns:
                labels[slot, :n] = g.columns[label_col][:n]
            if weight_col and weight_col in g.columns:
                weights[slot, :n] = g.columns[weight_col][:n]
            else:
                weights[slot, :n] = 1.0
            if offset_column_name in g.columns:
                offsets[slot, :n] = g.columns[offset_column_name][:n]
            if uid_col in g.columns:
                uids[slot, :n] = g.columns[uid_col][:n]
            theta0[slot] = _warm_start(c.unique, prior_models.get(g.entity_id),
                                       has_intercept, u)

        buckets.append(EntityBucket(
            entity_ids=entity_ids, indices=indices, values=values, offsets=offsets,
            labels=labels, weights=weights, uids=uids, sample_count=sample_count,
            unique_global_indices=unique_g, u_count=u_count, theta0=theta0))
    return buckets
