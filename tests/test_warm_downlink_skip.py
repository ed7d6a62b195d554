"""Warm-sweep downlink skip: a bucket whose entities all
converge AT their warm start reconstructs thetas from host theta0 instead of
fetching [B, dim] floats back over the link — and the result is identical."""
import numpy as np

import gdmix_tpu.models.random_effect_lr as RE

from tests.test_random_effect_lr import (_build_model, _make_groups,
                                         _write_dataset)


def test_unmoved_warm_refit_skips_fetch_and_matches(tmp_path, monkeypatch):
    groups, _ = _make_groups(num_entities=10, seed=17)
    md_file, train_dir, feature_file = _write_dataset(tmp_path, groups)
    # loose pgtol: the cold fit converges via the gradient test, so the warm
    # restart is done at iteration 0 (gmax already <= pgtol at theta0)
    model, base = _build_model(md_file, train_dir, feature_file, tmp_path,
                               lbfgs_pgtol=1e-6, lbfgs_tolerance=1e-12)
    cold = model.fit_groups(groups, {}, base)

    flags = []
    orig = RE._bucket_moved

    def spy(theta, theta0):
        out = orig(theta, theta0)
        flags.append(out)
        return out

    monkeypatch.setattr(RE, "_bucket_moved", spy)
    warm = model.fit_groups(groups, dict(cold), base)
    assert flags, "warm path never consulted the moved probe"
    moved = [bool(f) for f in flags]
    assert not any(moved), f"warm refit moved: {moved}"
    assert set(warm) == set(cold)
    for eid in cold:
        np.testing.assert_array_equal(np.asarray(warm[eid].theta),
                                      np.asarray(cold[eid].theta),
                                      err_msg=eid)

    # changed data through the same warm path still retrains (moved=True)
    flags.clear()
    groups2, _ = _make_groups(num_entities=10, seed=18)
    again = model.fit_groups(groups2, dict(cold), base)
    assert any(bool(f) for f in flags)
    assert set(again) >= set(cold)
