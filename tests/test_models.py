"""Stage-level golden tests: PC1 model + metric head vs the reference
pipeline behavior (stages B and C of SURVEY.md §3)."""

import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

from btcs_pnes_optical_flow.models import metrics as metrics_model
from btcs_pnes_optical_flow.models import pc1 as pc1_model
from tests import reference_impl as ri


def _flow_like(n, fs, rng):
    """Synthetic body-axis velocities: decaying clonic oscillation with a
    drifting principal axis, NaN gaps where axes were invalid."""
    t = np.arange(n) / fs
    phase = 2 * np.pi * (3.0 * t - 0.04 * t * t)
    amp = 3.0 * np.exp(-0.12 * t)
    theta = 0.4 + 0.15 * np.sin(2 * np.pi * 0.05 * t)
    vx = amp * np.sin(phase) * np.cos(theta) + 0.2 * rng.normal(size=n)
    vy = amp * np.sin(phase) * np.sin(theta) + 0.2 * rng.normal(size=n)
    vx[0] = np.nan  # frame 0 has no flow (optical_flow.py:236-242)
    vy[0] = np.nan
    return t, vx, vy


def _ref_stage_b(t, vx, vy):
    sos = scipy.signal.butter(4, [0.5 / 15, 5.0 / 15], btype="band", output="sos")
    vx_f = ri.ref_bandpass_nanrobust(vx, sos)
    vy_f = ri.ref_bandpass_nanrobust(vy, sos)
    return ri.ref_dynamic_pc1(t, vx_f, vy_f)


@pytest.mark.parametrize("gaps", [(), ((120, 160),)])
def test_pc1_stage_matches_reference(gaps, rng):
    n = 450
    t, vx, vy = _flow_like(n, 30.0, rng)
    for s, e in gaps:
        vx[s:e] = np.nan
        vy[s:e] = np.nan
    ref = _ref_stage_b(t, vx, vy)
    mine = np.asarray(
        pc1_model.pc1_from_flow(jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32))
    )
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    fin = np.isfinite(ref)
    # BASELINE target: waveform correlation >= 0.999.
    c = np.corrcoef(mine[fin], ref[fin])[0, 1]
    assert c > 0.999, c
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("fs", [30.0, 32.0])
def test_metrics_stage_matches_reference(fs, rng):
    n = int(12 * fs)  # 12 s; window keeps 0-10 s
    t, vx, vy = _flow_like(n, fs, rng)
    pc1 = _ref_stage_b(t, vx, vy)

    ref = ri.ref_metrics(t, pc1)
    mine = metrics_model.pc1_metrics(t, pc1)

    assert int(mine.status) == 0
    assert int(mine.peak_n) == ref["Peak_n"], (int(mine.peak_n), ref["Peak_n"])
    np.testing.assert_allclose(float(mine.pc1_area), ref["PC1_area_0_10"], rtol=1e-3)
    np.testing.assert_allclose(float(mine.ads_slope), ref["ADS_slope_0_10"], rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(float(mine.ads_r2), ref["ADS_R2_0_10"], rtol=1e-2, atol=1e-3)
    if np.isnan(ref["Kendall_tau_0_10"]):
        assert np.isnan(float(mine.kendall_tau))
    elif fs == 32.0:
        # 1/32-s grid is exactly representable in fp32 → interval tie
        # structure matches fp64 → τ must match to fp precision.
        np.testing.assert_allclose(float(mine.kendall_tau), ref["Kendall_tau_0_10"], atol=1e-5)
        np.testing.assert_allclose(float(mine.kendall_p), ref["Kendall_p_0_10"], rtol=5e-3, atol=1e-5)
    else:
        # On a 1/30-s grid fp32 rounding can break exact interval ties
        # (τ-b's tie correction is equality-sensitive); allow a small
        # deviation from the fp64 oracle.
        np.testing.assert_allclose(float(mine.kendall_tau), ref["Kendall_tau_0_10"], atol=0.02)


def test_metrics_stage_too_few_samples():
    t = np.arange(5) / 30.0
    x = np.sin(t)
    res = metrics_model.pc1_metrics(t, x)
    assert int(res.status) == 1
    assert np.isnan(float(res.pc1_area))
    with pytest.raises(RuntimeError):
        metrics_model.pc1_metrics(t, x, strict=True)


def test_metrics_stage_nan_heavy(rng):
    """Mostly-NaN PC1 still yields the reference's NaN/guard behavior."""
    n = 400
    t = np.arange(n) / 30.0
    pc1 = np.full(n, np.nan)
    pc1[::3] = np.sin(2 * np.pi * 3.0 * t[::3])  # sparse valid samples
    ref = ri.ref_metrics(t, pc1)
    mine = metrics_model.pc1_metrics(t, pc1)
    assert int(mine.status) == 0
    assert int(mine.peak_n) == ref["Peak_n"]
    if np.isnan(ref["PC1_area_0_10"]):
        assert np.isnan(float(mine.pc1_area))


def test_pc1_batch(rng):
    n = 360
    t, vx, vy = _flow_like(n, 30.0, rng)
    vxb = jnp.asarray(np.stack([vx, vy]), jnp.float32)  # 2 "videos"
    vyb = jnp.asarray(np.stack([vy, vx]), jnp.float32)
    out = pc1_model.pc1_from_flow_batch(vxb, vyb)
    assert out.shape == (2, n)
