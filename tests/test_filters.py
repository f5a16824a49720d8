"""Differential tests: JAX filter ops vs SciPy reference behavior.

Covers the behavioral contract of optical_PCA.py:64-121 and
optical_PC1.py:47-76 (SURVEY.md C10-C13, C18-C19).
"""

import numpy as np
import pytest
import scipy.ndimage
import scipy.signal

import jax.numpy as jnp

from btcs_pnes_optical_flow.ops import design, filters


def _ref_sos():
    return scipy.signal.butter(4, [0.5 / 15, 5.0 / 15], btype="band", output="sos")


@pytest.mark.parametrize(
    "lo,hi,fs,order",
    [(0.5, 5.0, 30, 4), (0.5, 5.0, 30, 2), (1.0, 8.0, 60, 3), (0.2, 2.0, 25, 5), (2.0, 10.0, 30, 6)],
)
def test_native_butter_design_matches_scipy(lo, hi, fs, order):
    mine = design.butter_bandpass_sos(lo, hi, fs, order)
    ref = scipy.signal.butter(order, [lo / (fs / 2), hi / (fs / 2)], btype="band", output="sos")
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(design.sosfilt_zi(ref), scipy.signal.sosfilt_zi(ref), rtol=1e-9)


def test_design_validates_band():
    with pytest.raises(ValueError):
        design.butter_bandpass_sos(5.0, 0.5, 30, 4)
    with pytest.raises(ValueError):
        design.butter_bandpass_sos(0.5, 16.0, 30, 4)


@pytest.mark.parametrize("engine", ["scan", "assoc"])
def test_sosfilt_matches_scipy(engine, rng):
    sos = _ref_sos()
    zi = scipy.signal.sosfilt_zi(sos)
    x = rng.normal(size=300).astype(np.float64)
    y_ref, zf_ref = scipy.signal.sosfilt(sos, x, zi=zi)
    y, zf = filters.sosfilt(
        jnp.asarray(sos, jnp.float32), jnp.asarray(x, jnp.float32), jnp.asarray(zi, jnp.float32), engine=engine
    )
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(zf), zf_ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("engine", ["scan", "assoc"])
@pytest.mark.parametrize("n", [60, 301, 1024])
def test_sosfiltfilt_matches_scipy(engine, n, rng):
    sos = _ref_sos()
    zi = scipy.signal.sosfilt_zi(sos)
    padlen = design.sos_required_padlen(sos)
    pad = min(padlen, n // 2 - 1)
    t = np.arange(n) / 30.0
    x = np.sin(2 * np.pi * 2.0 * t) + 0.3 * rng.normal(size=n)
    y_ref = scipy.signal.sosfiltfilt(sos, x, padlen=pad)
    y = filters.sosfiltfilt(
        jnp.asarray(sos, jnp.float32),
        jnp.asarray(x, jnp.float32),
        jnp.asarray(zi, jnp.float32),
        pad,
        engine=engine,
    )
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=5e-4, atol=5e-4)


def _ref_bandpass_nanrobust(x, sos):
    """Reference bandpass_nanrobust re-expressed from optical_PCA.py:96-121."""
    x = np.asarray(x, dtype=float)
    y = np.full_like(x, np.nan)
    m = np.isfinite(x)
    nsec = sos.shape[0]
    padreq = 3 * ((2 * nsec + 1) - 1)
    minlen = padreq + 1
    idx = np.flatnonzero(m)
    if idx.size == 0:
        return y
    gap = np.where(np.diff(idx) > 1)[0]
    s_list = np.r_[idx[0], idx[gap + 1]]
    e_list = np.r_[idx[gap], idx[-1]]
    for s, e in zip(s_list, e_list):
        seg = x[s : e + 1]
        if seg.size < minlen:
            continue
        pad = min(padreq, int(seg.size // 2 - 1))
        if pad <= 0:
            y[s : e + 1] = seg
        else:
            y[s : e + 1] = scipy.signal.sosfiltfilt(sos, seg, padlen=pad)
    return y


@pytest.mark.parametrize("engine", ["scan", "assoc"])
def test_bandpass_nanrobust_matches_reference(engine, rng):
    sos_np = _ref_sos()
    sos, zi, padreq = filters.make_bandpass(0.5, 5.0, 30.0, 4)
    n = 400
    t = np.arange(n) / 30.0
    x = np.sin(2 * np.pi * 3.0 * t) * np.exp(-t / 8) + 0.1 * rng.normal(size=n)
    # NaN gaps: one run too short to filter (< 25), several valid runs.
    x[50:60] = np.nan     # splits [0,50) run (len 50, filtered)
    x[70:80] = np.nan     # [60,70) run has len 10 < 25 → stays NaN
    x[300:302] = np.nan   # long runs either side
    y_ref = _ref_bandpass_nanrobust(x, sos_np)
    y = filters.bandpass_nanrobust(jnp.asarray(x, jnp.float32), sos, zi, padreq, max_runs=8, engine=engine)
    y = np.asarray(y)
    assert np.array_equal(np.isnan(y), np.isnan(y_ref))
    fin = np.isfinite(y_ref)
    np.testing.assert_allclose(y[fin], y_ref[fin], rtol=5e-4, atol=5e-4)


def test_bandpass_nanrobust_all_nan():
    sos, zi, padreq = filters.make_bandpass(0.5, 5.0, 30.0, 4)
    x = jnp.full((100,), jnp.nan)
    y = filters.bandpass_nanrobust(x, sos, zi, padreq, max_runs=4)
    assert np.all(np.isnan(np.asarray(y)))


def test_bandpass_nanrobust_short_signal():
    """Signals shorter than minlen stay entirely NaN."""
    sos, zi, padreq = filters.make_bandpass(0.5, 5.0, 30.0, 4)
    x = jnp.asarray(np.sin(np.arange(20.0)), jnp.float32)
    y = filters.bandpass_nanrobust(x, sos, zi, padreq, max_runs=4)
    assert np.all(np.isnan(np.asarray(y)))


@pytest.mark.parametrize("size", [3, 5, 7, 61])
def test_uniform_filter1d_nearest(size, rng):
    x = rng.normal(size=237)
    ref = scipy.ndimage.uniform_filter1d(x, size=size, mode="nearest")
    mine = filters.uniform_filter1d_nearest(jnp.asarray(x, jnp.float32), size)
    np.testing.assert_allclose(np.asarray(mine), ref, rtol=1e-5, atol=1e-6)


def _ref_smooth_ma_nan(x, fs, sec):
    """smooth_ma_nan re-expressed from optical_PC1.py:55-76."""
    x = np.asarray(x, dtype=float)
    if sec <= 0:
        return x.copy()
    k = int(max(1, round(fs * sec))) | 1
    valid = np.isfinite(x).astype(float)
    x2 = x.copy()
    x2[~np.isfinite(x2)] = 0.0
    num = scipy.ndimage.uniform_filter1d(x2, size=k, mode="nearest")
    den = scipy.ndimage.uniform_filter1d(valid, size=k, mode="nearest")
    y = num / np.maximum(den, 1e-12)
    y[den < 1e-12] = np.nan
    return y


def test_smooth_ma_nan_matches_reference(rng):
    fs, sec = 30.0, 0.2
    x = rng.normal(size=301)
    x[40:55] = np.nan
    x[0] = np.nan
    ref = _ref_smooth_ma_nan(x, fs, sec)
    k = filters.smooth_window_len(fs, sec)
    mine = np.asarray(filters.smooth_ma_nan(jnp.asarray(x, jnp.float32), k))
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=1e-4, atol=1e-5)


def test_smooth_ma_nan_all_nan_window():
    """A window with no valid samples yields NaN."""
    x = np.full(50, np.nan)
    x[0:10] = 1.0
    k = 7
    mine = np.asarray(filters.smooth_ma_nan(jnp.asarray(x, jnp.float32), k))
    assert np.all(np.isnan(mine[14:]))
    assert np.all(np.isfinite(mine[0:10]))


def test_smooth_window_len_matches_reference():
    for fs in [29.97, 30.0, 25.0, 59.94]:
        for sec in [0.2, 2.0]:
            k_ref = int(max(1, round(fs * sec))) | 1
            assert filters.smooth_window_len(fs, sec) == k_ref
