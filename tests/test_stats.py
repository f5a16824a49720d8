"""Differential tests: rank stats / regressions vs SciPy (C22-C25, N10-N12)."""

import numpy as np
import pytest
import scipy.stats

import jax.numpy as jnp

from btcs_pnes_optical_flow.ops import stats
from tests import reference_impl as ri


def _masked(x, cap=40):
    n = len(x)
    buf = np.zeros(cap, np.float32)
    buf[:n] = x
    m = np.zeros(cap, bool)
    m[:n] = True
    return jnp.asarray(buf), jnp.asarray(m)


class TestKendall:
    def check(self, x, y, rtol_tau=1e-5, rtol_p=2e-3):
        ref = scipy.stats.kendalltau(x, y)
        xb, m = _masked(x)
        yb, _ = _masked(y)
        tau, p = stats.kendalltau_masked(xb, yb, m)
        tau, p = float(tau), float(p)
        if np.isnan(ref.statistic):
            assert np.isnan(tau)
        else:
            assert abs(tau - ref.statistic) < max(rtol_tau, abs(ref.statistic) * rtol_tau)
            assert abs(p - ref.pvalue) < max(1e-5, ref.pvalue * rtol_p), (p, ref.pvalue)

    def test_no_ties_small(self, rng):
        for n in [5, 8, 12, 20, 33]:
            x = rng.normal(size=n)
            y = 0.5 * x + rng.normal(size=n)
            self.check(x, y)

    def test_with_ties(self, rng):
        # Grid-quantized values → ties, asymptotic path.
        for n in [8, 15, 30]:
            x = np.round(rng.normal(size=n) * 3) / 3
            y = np.round((0.3 * x + rng.normal(size=n)) * 3) / 3
            self.check(x, y)

    def test_perfect_monotonic(self):
        x = np.arange(10.0)
        self.check(x, 2 * x + 1)
        self.check(x, -x)

    def test_large_n_no_ties(self, rng):
        # n > 33, no ties → asymptotic unless nearly perfectly sorted.
        x = rng.normal(size=38)
        y = 0.8 * x + 0.01 * rng.normal(size=38)
        self.check(x, y)

    def test_large_n_near_perfect(self, rng):
        # n > 33, c <= 1 → scipy still uses the exact closed form.
        x = np.sort(rng.normal(size=36))
        y = np.arange(36.0)
        self.check(x, y)

    def test_all_tied_x(self):
        x = np.ones(8)
        y = np.arange(8.0)
        xb, m = _masked(x)
        yb, _ = _masked(y)
        tau, p = stats.kendalltau_masked(xb, yb, m)
        assert np.isnan(float(tau)) and np.isnan(float(p))

    def test_interval_like_data(self, rng):
        # Inter-peak intervals: multiples of 1/30 s with repeats.
        T = np.array([4, 4, 5, 5, 5, 6, 6, 7, 8, 8, 9]) / 30.0
        tm = np.cumsum(T) - T / 2
        self.check(tm, T)


class TestRegressions:
    def test_linregress(self, rng):
        x = rng.normal(size=25)
        y = 1.7 * x - 0.3 + 0.2 * rng.normal(size=25)
        ref = scipy.stats.linregress(x, y)
        xb, m = _masked(x)
        yb, _ = _masked(y)
        slope, intercept, r = stats.linregress_masked(xb, yb, m)
        assert abs(float(slope) - ref.slope) < 1e-4
        assert abs(float(intercept) - ref.intercept) < 1e-4
        assert abs(float(r) - ref.rvalue) < 1e-4

    def test_exp_decay_regression(self, rng):
        t = np.arange(100) / 30.0
        amp = 2.0 * np.exp(-0.35 * t) * (1 + 0.05 * rng.normal(size=100))
        amp[10:15] = np.nan
        amp[50] = -1.0  # non-positive must be excluded
        ref = ri.ref_exp_decay_regression(t, amp)
        tb, m = _masked(t, 128)
        ab, _ = _masked(np.nan_to_num(amp, nan=np.nan), 128)
        ab = jnp.asarray(np.pad(amp.astype(np.float32), (0, 28), constant_values=0))
        slope, r = stats.exp_decay_regression_masked(tb, ab, m)
        assert abs(float(slope) - ref["slope"]) < 2e-3
        assert abs(float(r) - ref["r"]) < 2e-3

    def test_exp_decay_too_few(self):
        t = np.arange(5.0)
        amp = np.array([np.nan, np.nan, -1, 0, np.nan])
        tb, m = _masked(t, 8)
        ab = jnp.asarray(np.pad(amp.astype(np.float32), (0, 3)))
        slope, r = stats.exp_decay_regression_masked(tb, ab, m)
        assert np.isnan(float(slope)) and np.isnan(float(r))


class TestAucFs:
    def test_safe_auc(self, rng):
        t = np.arange(301) / 30.0
        a = np.abs(np.sin(t * 3)) + 0.1
        a[40:60] = np.nan
        ref = ri.ref_safe_auc(a, t)
        auc = stats.safe_auc_masked(jnp.asarray(a, jnp.float32), jnp.asarray(t, jnp.float32))
        assert abs(float(auc) - ref) < 1e-3

    def test_safe_auc_too_few(self):
        a = np.array([1.0, np.nan, np.nan])
        t = np.arange(3.0)
        auc = stats.safe_auc_masked(jnp.asarray(a, jnp.float32), jnp.asarray(t, jnp.float32))
        assert np.isnan(float(auc))

    def test_estimate_fs(self):
        t = np.arange(200) / 29.97
        t[50] += 0.004  # jitter
        ref = ri.ref_estimate_fs_from_time(t)
        tb, m = _masked(t, 256)
        fs = stats.estimate_fs_masked(tb, m)
        assert abs(float(fs) - ref) < 1e-2
