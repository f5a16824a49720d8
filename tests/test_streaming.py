"""Streaming/cohort tests: chunked PC1 equivalence, cohort runner."""

import numpy as np
import pytest

from btcs_pnes_optical_flow.config import PCAParams, PipelineConfig, MetricParams
from btcs_pnes_optical_flow.models.streaming import pc1_streaming
from btcs_pnes_optical_flow.models.pc1 import pc1_from_flow
from btcs_pnes_optical_flow.parallel.runner import CohortItem, run_cohort
from btcs_pnes_optical_flow.dataio.video import ArraySource


def _long_signal(n, rng):
    t = np.arange(n) / 30.0
    phase = 2 * np.pi * (3.0 * t - 0.01 * t * t)
    amp = 2.5 * (1 + 0.3 * np.sin(2 * np.pi * 0.05 * t))
    theta = 0.4 + 0.2 * np.sin(2 * np.pi * 0.02 * t)
    vx = amp * np.sin(phase) * np.cos(theta) + 0.1 * rng.normal(size=n)
    vy = amp * np.sin(phase) * np.sin(theta) + 0.1 * rng.normal(size=n)
    vx[0] = vy[0] = np.nan
    vx[900:950] = np.nan
    vy[900:950] = np.nan
    return vx, vy


def test_pc1_streaming_matches_full(rng):
    import jax.numpy as jnp

    n = 3000
    vx, vy = _long_signal(n, rng)
    full = np.asarray(
        pc1_from_flow(jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32))
    )
    chunked = pc1_streaming(vx, vy, chunk_n=1024, margin_n=240)
    assert np.array_equal(np.isnan(chunked), np.isnan(full))
    fin = np.isfinite(full)
    # Transient tolerance: band-pass boundary effects are ~2e-4 rel.
    c = np.corrcoef(chunked[fin], full[fin])[0, 1]
    assert c > 0.9999, c
    np.testing.assert_allclose(chunked[fin], full[fin], rtol=5e-3, atol=5e-3)


def test_cohort_runner_isolates_failures(rng, tmp_path):
    from tests.test_pipeline import ROI, make_skeleton, render_clip

    clip = render_clip(n_frames=60)
    skel = make_skeleton(len(clip))
    good = CohortItem("good", ArraySource(clip, fps=30.0), skel, [ROI])

    class Broken:
        pass

    bad = CohortItem("bad", "/nonexistent/file.mp4", skel, [ROI])
    cfg = PipelineConfig(metrics=MetricParams(window_sec=2.0))
    df = run_cohort([good, bad], cfg, chunk_pairs=16, out_csv=str(tmp_path / "cohort.csv"))
    assert len(df) == 2
    g = df[df["video"] == "good"][0]
    b = df[df["video"] == "bad"][0]
    assert g["error"] == ""
    assert b["status"] == -1 and b["error"] != ""
    assert np.isnan(b["PC1_area_0_10"])
    import os

    assert os.path.exists(tmp_path / "cohort.csv")
