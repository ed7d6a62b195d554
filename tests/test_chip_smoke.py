"""chip_smoke.py's float64 references, checked at tiny sizes on the CPU
(the script itself needs a GPU)."""
import numpy as np
from scipy.optimize import fmin_l_bfgs_b
from scipy.special import expit

from chip_smoke import fe_reference, re_newton_oracle


def test_fe_reference_matches_dense_numpy():
    """Gather/scatter reference == the dense-matrix objective, duplicate ids
    within a record accumulating."""
    rng = np.random.RandomState(0)
    n, k, d, lam = 40, 5, 12, 0.9
    idx = rng.randint(0, d, (n, k))
    val = rng.randn(n, k) * (rng.rand(n, k) < 0.7)
    off, y, wt = 0.2 * rng.randn(n), (rng.rand(n) < 0.5) * 1.0, rng.rand(n)
    X = np.zeros((n, d))
    np.add.at(X, (np.repeat(np.arange(n), k), idx.ravel()), val.ravel())
    x = rng.randn(d + 1)
    z = X @ x[:-1] + x[-1] + off
    v_want = (np.sum(wt * (np.logaddexp(0, z) - z * y))
              + 0.5 * lam * x[:-1] @ x[:-1])
    r = wt * (expit(z) - y)
    g_want = np.concatenate([X.T @ r + lam * x[:-1], [r.sum()]])
    v, g = fe_reference(x, idx, val, off, y, wt, l2=lam)
    np.testing.assert_allclose(v, v_want, rtol=1e-12)
    np.testing.assert_allclose(g, g_want, rtol=1e-12, atol=1e-12)


def test_re_newton_oracle_matches_scipy():
    """The per-entity Newton oracle reaches scipy's optimum of the mean-form
    objective with an unregularized intercept."""
    rng = np.random.RandomState(1)
    n, d, lam = 30, 7, 1.0
    X = np.concatenate([np.ones((n, 1)), rng.randn(n, d - 1)], axis=1)
    y = (rng.rand(n) < 0.4) * 1.0
    y[:2] = [0.0, 1.0]
    w, off = rng.rand(n) + 0.5, 0.1 * rng.randn(n)
    mask = np.r_[0.0, np.ones(d - 1)]

    def fg(t):
        z = X @ t + off
        f = (np.sum(w * (np.logaddexp(0, z) - z * y))
             + 0.5 * lam * np.sum(mask * t * t)) / n
        return f, (X.T @ (w * (expit(z) - y)) + lam * mask * t) / n

    want = fmin_l_bfgs_b(fg, np.zeros(d), m=10, factr=10.0, pgtol=1e-12,
                         maxiter=1000)[0]
    got = re_newton_oracle(X, y, w, off, lam)
    np.testing.assert_allclose(got, want, atol=1e-6)
