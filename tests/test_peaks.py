"""Differential tests: cycle/peak detection vs reference behavior (C20-C21)."""

import numpy as np
import pytest

import jax.numpy as jnp

from btcs_pnes_optical_flow.ops import peaks
from btcs_pnes_optical_flow.ops.filters import smooth_window_len
from tests import reference_impl as ri


def _pc1_like(n, fs, rng, decay=0.25, f0=3.0, chirp=-0.08):
    """Clonic-like decaying oscillation with slowing frequency."""
    t = np.arange(n) / fs
    phase = 2 * np.pi * (f0 * t + 0.5 * chirp * t * t)
    x = np.exp(-decay * t) * np.sin(phase)
    x += 0.05 * rng.normal(size=n)
    return t, x


def _run_mine(pc1, t, fs, m_count=None, cap=None):
    n = len(pc1)
    cap = cap or n
    k = smooth_window_len(fs, 0.2)
    p95w = max(3, int(round(fs * 2.0)) | 1)
    buf_p = np.full(cap, np.nan, np.float32)
    buf_t = np.full(cap, np.nan, np.float32)
    buf_p[:n] = pc1
    buf_t[:n] = t
    res = peaks.detect_cycles_positive_peaks(
        jnp.asarray(buf_p), jnp.asarray(buf_t), k, p95w, m_count if m_count is not None else n
    )
    np_ = int(res.n_peaks)
    ni = int(res.n_intervals)
    return (
        np.asarray(res.pc1_s)[:n],
        np.asarray(res.t_peaks)[:np_],
        np.asarray(res.tm)[:ni],
        np.asarray(res.T)[:ni],
    )


def test_rolling_p95_matches_reference(rng):
    fs = 30.0
    t, x = _pc1_like(301, fs, rng)
    sm = ri.ref_smooth_ma_nan(x, fs, 0.2)
    ref = ri.ref_rolling_p95_positive(sm, fs, 2.0)
    p95w = max(3, int(round(fs * 2.0)) | 1)
    mine = np.asarray(peaks.rolling_p95_positive(jnp.asarray(sm, jnp.float32), p95w, len(sm)))
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["clean", "nangap", "sparse"])
def test_detect_cycles_matches_reference(case, rng):
    fs = 30.0
    t, x = _pc1_like(301, fs, rng)
    if case == "nangap":
        x[100:130] = np.nan
    elif case == "sparse":
        x[::7] = np.nan
    ref_s, ref_tp, ref_tm, ref_T = ri.ref_detect_cycles(x, t, fs)
    my_s, my_tp, my_tm, my_T = _run_mine(x, t, fs)

    fin = np.isfinite(ref_s)
    assert np.array_equal(np.isnan(my_s), np.isnan(ref_s))
    np.testing.assert_allclose(my_s[fin], ref_s[fin], rtol=5e-4, atol=5e-5)
    assert len(my_tp) == len(ref_tp), (my_tp, ref_tp)
    np.testing.assert_allclose(my_tp, ref_tp, atol=1e-5)
    np.testing.assert_allclose(my_tm, ref_tm, atol=1e-5)
    np.testing.assert_allclose(my_T, ref_T, atol=1e-5)


def test_detect_cycles_padded_capacity(rng):
    """Results must be identical when the buffer has unused capacity."""
    fs = 30.0
    t, x = _pc1_like(200, fs, rng)
    a = _run_mine(x, t, fs)
    b = _run_mine(x, t, fs, m_count=200, cap=256)
    np.testing.assert_allclose(a[1], b[1], atol=1e-6)
    np.testing.assert_allclose(a[3], b[3], atol=1e-6)


def test_detect_cycles_few_peaks(rng):
    """< 2 kept peaks → empty tm/T (optical_PC1.py:201-202)."""
    fs = 30.0
    n = 301
    t = np.arange(n) / fs
    x = np.ones(n) * 0.5  # no zero crossings at all
    _, tp, tm, T = _run_mine(x, t, fs)
    assert len(tp) == 0 and len(tm) == 0 and len(T) == 0
    ref_s, ref_tp, ref_tm, ref_T = ri.ref_detect_cycles(x, t, fs)
    assert len(ref_tp) == 0


def test_detect_cycles_merge_rule(rng):
    """Close double-peaks must merge keeping the larger (and its time)."""
    fs = 30.0
    n = 400
    t = np.arange(n) / fs
    x = np.zeros(n)
    # Pairs of nearby peaks: cycles shorter than 0.2 s apart.
    for c, a in [(50, 1.0), (53, 1.4), (100, 1.2), (104, 0.9), (200, 1.0), (260, 1.1), (320, 0.8)]:
        x += a * np.exp(-0.5 * ((np.arange(n) - c) / 1.5) ** 2)
    x -= 0.25  # push baseline below zero between peaks
    ref_s, ref_tp, ref_tm, ref_T = ri.ref_detect_cycles(x, t, fs)
    _, my_tp, my_tm, my_T = _run_mine(x, t, fs)
    assert len(my_tp) == len(ref_tp)
    np.testing.assert_allclose(my_tp, ref_tp, atol=1e-5)
    np.testing.assert_allclose(my_T, ref_T, atol=1e-5)
