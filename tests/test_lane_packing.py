"""Bucket plan: per-entity pow-2 tiers, one bucket per tier. Cross-tier lane
packing and pow-2 batch decomposition were measured slower on an earlier
accelerator with a 25 ms dispatch (see plan_lane_buckets' docstring): dispatch
latency and iteration coupling dominate padded rows. These tests pin the
surviving plan's contract."""
import numpy as np

from gdmix_tpu.data.bucketing import _sample_caps, plan_lane_buckets


def test_plan_covers_exactly_one_bucket_per_tier():
    rng = np.random.RandomState(1)
    counts = np.clip((rng.pareto(1.2, 20_000) * 8).astype(np.int64) + 2,
                     2, 2048)
    caps = np.asarray(_sample_caps(counts, 8))
    plan = plan_lane_buckets(counts, caps)
    seen = np.concatenate([m for _, m in plan])
    assert len(seen) == len(counts)
    assert len(np.unique(seen)) == len(counts)          # exact cover
    tiers_seen = set()
    for n_cap, members in plan:
        assert counts[members].max() <= n_cap           # cap bound holds
        # tightest tier: every member is ABOVE the previous cap (per-entity
        # assignment — no cross-tier promotion)
        below = caps[caps < n_cap]
        if len(below):
            assert counts[members].min() > below.max()
        assert n_cap in caps
        assert n_cap not in tiers_seen                  # one bucket per tier
        tiers_seen.add(n_cap)
    assert len(plan) == len(np.unique(
        np.searchsorted(caps, counts, side="left")))


def test_plan_members_in_original_order():
    """Within a tier, members keep dataset order (stable downstream slot
    assignment, deterministic across the object and columnar paths)."""
    counts = np.asarray([3, 40, 9, 17, 2, 33], np.int64)
    caps = np.asarray(_sample_caps(counts, 8))
    plan = plan_lane_buckets(counts, caps)
    by_cap = {c: m.tolist() for c, m in plan}
    assert by_cap == {8: [0, 4], 16: [2], 32: [3], 40: [1, 5]}


def test_plan_latency_adaptive_extremes():
    """The packing decision keys on the MEASURED dispatch latency. A slow
    (25 ms) dispatch with realistically sized tiers keeps the per-tier plan;
    a fast local dispatch merges tiers whose promoted rows cost less than the
    dispatch they save; and trivially tiny tiers merge even at 25 ms."""
    from gdmix_tpu.data.bucketing import PACK_PROMOTED_ROW_COST_S
    rng = np.random.RandomState(3)
    counts = np.clip((rng.pareto(1.2, 50_000) * 8).astype(np.int64) + 2,
                     2, 2048)
    caps = np.asarray(_sample_caps(counts, 8))
    base = plan_lane_buckets(counts, caps)
    slow = plan_lane_buckets(counts, caps, dispatch_latency_s=25e-3)
    pcie = plan_lane_buckets(counts, caps, dispatch_latency_s=3e-4)
    # this mix's tiers are all big (26k..147 members): no tier merges at
    # either latency (promotion would cost >= 33k row-slots, > 25 ms worth)
    # — the low tiers of the measured per-tier plan survive verbatim
    assert [(c, len(m)) for c, m in slow][:6] == [(c, len(m))
                                                  for c, m in base][:6]
    assert {c for c, _ in slow} == {c for c, _ in base}   # no promotions
    # cheaper dispatches can only ADD decomposition splits, never merges
    assert len(pcie) >= len(slow) >= len(base)
    for plan in (slow, pcie):
        seen = np.concatenate([m for _, m in plan])
        assert len(seen) == len(counts) == len(np.unique(seen))
        for n_cap, members in plan:
            assert counts[members].max() <= n_cap

    # merge extreme: trivially tiny tiers merge whenever the dispatch they
    # save beats their promoted rows — at a slow dispatch especially
    tiny = np.asarray([2] * 3 + [500] * 4000, np.int64)
    caps2 = np.asarray(_sample_caps(tiny, 8))
    merged = plan_lane_buckets(tiny, caps2, dispatch_latency_s=25e-3)
    # 3 entities promoted 8->504: 1488 rows * 7.5e-7 << 25 ms -> merge
    assert len(merged) == 1 and merged[0][0] == caps2[-1]
    assert 1488 * PACK_PROMOTED_ROW_COST_S < 25e-3
    # ...but NOT when dispatch is nearly free (the tiny tier survives)
    kept = plan_lane_buckets(tiny, caps2, dispatch_latency_s=3e-5)
    assert kept[0][0] == 8 and len(kept[0][1]) == 3

    # decomposition extreme: a big-batch tier with heavy pow2 padding
    # (530 entities -> pow2 1024: 494 padded lanes x 40 rows) splits into
    # 128-blocks when dispatches are cheap, stays whole at 25 ms
    big = np.asarray([40] * 530, np.int64)
    caps3 = np.asarray(_sample_caps(big, 8))
    on_slow = plan_lane_buckets(big, caps3, dispatch_latency_s=25e-3)
    on_pcie = plan_lane_buckets(big, caps3, dispatch_latency_s=3e-4)
    assert len(on_slow) == 1
    assert len(on_pcie) == 5 and all(len(m) <= 128 for _, m in on_pcie)
    seen = np.concatenate([m for _, m in on_pcie])
    assert len(seen) == len(big) == len(np.unique(seen))
