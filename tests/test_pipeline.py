"""End-to-end integration tests (SURVEY.md §4.5): synthetic clip through
the full chain, differential against the cv2-based reference behavior."""

import io
import os

import numpy as np
import pytest

from btcs_pnes_optical_flow.config import MetricParams, PipelineConfig
from btcs_pnes_optical_flow.dataio import contracts
from btcs_pnes_optical_flow.dataio.video import ArraySource, Y4MSource
from btcs_pnes_optical_flow.models import pipeline
from tests import reference_impl as ri


def render_clip(n_frames=96, h=64, w=80, fps=30.0, f0=3.0, seed=0):
    """Oscillating Gaussian blob inside the ROI, decaying amplitude."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / fps
    cx = w * 0.5 + 12 * np.exp(-0.1 * t) * np.sin(2 * np.pi * f0 * t)
    cy = h * 0.5 + 5 * np.exp(-0.1 * t) * np.cos(2 * np.pi * f0 * t * 0.98)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((n_frames, h, w), np.uint8)
    # Strong low-frequency texture keeps the 2x2 flow solve well
    # conditioned everywhere (flat regions amplify fp32-vs-double noise
    # through the +1e-3-regularized solve, in both implementations).
    texture = (
        25 * np.sin(xx / 5.3) * np.cos(yy / 6.1)
        + 15 * np.sin((xx + 2 * yy) / 9.7)
        + rng.normal(0, 4, (h, w))
    )
    for i in range(n_frames):
        blob = 170 * np.exp(-(((xx - cx[i]) / 9.0) ** 2 + ((yy - cy[i]) / 8.0) ** 2))
        img = np.clip(80 + texture + blob, 0, 255)
        frames[i] = img.astype(np.uint8)
    return frames


def make_skeleton(n_frames, fps=30.0, nan_rows=()):
    t = np.arange(n_frames) / fps
    theta = 0.3 + 0.05 * np.sin(2 * np.pi * 0.1 * t)
    ex = np.stack([np.cos(theta), -np.sin(theta)], axis=1)
    ey = np.stack([np.sin(theta), np.cos(theta)], axis=1)
    for s, e in nan_rows:
        ex[s:e] = np.nan
        ey[s:e] = np.nan
    return contracts.Skeleton(time_all=t, fps=fps, ex=ex, ey=ey)


ROI = np.array([[8.0, 8.0], [72.0, 10.0], [70.0, 56.0], [10.0, 54.0]])


@pytest.fixture(scope="module")
def clip():
    return render_clip()


@pytest.fixture(scope="module")
def flow_pair(clip):
    """(ours, oracle) flow stage results computed once per module."""
    import cv2

    skel = make_skeleton(len(clip), nan_rows=((40, 44),))
    res = pipeline.run_flow_stage(
        ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=32
    )
    roi_mask = np.zeros(clip.shape[1:], np.uint8)
    cv2.fillPoly(roi_mask, [ROI.astype(np.int32)], 1)
    ref = ri.ref_flow_stage(clip, skel.time_all, 30.0, skel.ex, skel.ey, roi_mask.astype(bool))
    return res, ref, skel


def test_flow_stage_matches_reference(flow_pair):
    res, ref, _ = flow_pair
    assert len(res.frame) == len(ref)
    np.testing.assert_array_equal(res.skel_idx, ref["skel_idx"].to_numpy())
    np.testing.assert_array_equal(res.axes_ok.astype(int), ref["axes_ok"].to_numpy())
    np.testing.assert_allclose(res.t_sec, ref["t_sec"].to_numpy(), atol=1e-9)
    for mine_col, ref_col in [(res.vx[:, 0], "vx_body"), (res.vy[:, 0], "vy_body"), (res.mag[:, 0], "mag_body")]:
        refv = ref[ref_col].to_numpy()
        assert np.array_equal(np.isnan(mine_col), np.isnan(refv))
        fin = np.isfinite(refv)
        np.testing.assert_allclose(mine_col[fin], refv[fin], rtol=1e-3, atol=1e-3)


def test_full_chain_matches_reference(flow_pair, tmp_path):
    import scipy.signal

    res, ref, skel = flow_pair
    cfg = PipelineConfig(metrics=MetricParams(window_sec=3.0))

    pc1 = pipeline.run_pc1_stage(res, cfg, out_csv=str(tmp_path / "flow_pc1.csv"))
    # Reference stages B, C on the reference stage-A output.
    sos = scipy.signal.butter(4, [0.5 / 15, 5.0 / 15], btype="band", output="sos")
    vxf = ri.ref_bandpass_nanrobust(ref["vx_body"].to_numpy(), sos)
    vyf = ri.ref_bandpass_nanrobust(ref["vy_body"].to_numpy(), sos)
    ref_pc1 = ri.ref_dynamic_pc1(ref["t_sec"].to_numpy(), vxf, vyf)

    fin = np.isfinite(ref_pc1)
    assert np.array_equal(np.isnan(pc1[:, 0]), np.isnan(ref_pc1))
    c = np.corrcoef(pc1[fin, 0], ref_pc1[fin])[0, 1]
    assert c > 0.999, c

    mets = pipeline.run_metrics_stage(res.t_sec, pc1, cfg, out_csv=str(tmp_path / "summary.csv"))
    ref_m = ri.ref_metrics(ref["t_sec"].to_numpy(), ref_pc1, window_sec=3.0)
    assert int(mets[0].peak_n) == ref_m["Peak_n"]
    np.testing.assert_allclose(float(mets[0].pc1_area), ref_m["PC1_area_0_10"], rtol=5e-3)
    # CSV artifacts exist with the contract columns.
    import pandas as pd

    s = pd.read_csv(tmp_path / "summary.csv")
    assert list(s.columns) == contracts.SUMMARY_COLUMNS
    p = pd.read_csv(tmp_path / "flow_pc1.csv")
    assert list(p.columns) == contracts.PC1_COLUMNS


def test_flow_csv_roundtrip(flow_pair, tmp_path):
    res, _, _ = flow_pair
    path = str(tmp_path / "flow.csv")
    contracts.write_csv(path, res.columns(0))
    cols = contracts.read_flow_csv(path)
    assert list(cols) == contracts.FLOW_COLUMNS
    np.testing.assert_array_equal(cols["vx_body"], res.vx[:, 0])


def test_chunk_size_invariance(clip):
    """Chunked execution must not depend on the chunk size."""
    skel = make_skeleton(len(clip))
    a = pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=32)
    b = pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=19)
    fin = np.isfinite(a.vx[:, 0])
    np.testing.assert_allclose(a.vx[fin, 0], b.vx[fin, 0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.mag[fin, 0], b.mag[fin, 0], rtol=1e-6, atol=1e-7)


def test_y4m_source_roundtrip(tmp_path, clip):
    """Self-contained Y4M parsing: luma plane equals the gray frames."""
    path = tmp_path / "clip.y4m"
    h, w = clip.shape[1:]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for fr in clip[:10]:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
            f.write(np.full((h // 2) * (w // 2) * 2, 128, np.uint8).tobytes())
    src = Y4MSource(str(path))
    assert (src.width, src.height) == (w, h)
    assert abs(src.fps - 30.0) < 1e-9
    got = [g for g, _ in src.frames()]
    assert len(got) == 10
    np.testing.assert_array_equal(np.stack(got), clip[:10])


def test_pos_msec_timestamps(clip):
    """CAP_PROP_POS_MSEC-style timestamps take precedence when > 0."""
    skel = make_skeleton(len(clip))
    pos = 1000.0 * (np.arange(len(clip)) / 30.0) + 7.0  # offset container clock
    src = ArraySource(clip, fps=30.0, pos_msec=pos)
    res = pipeline.run_flow_stage(src, skel, [ROI], chunk_pairs=32)
    np.testing.assert_allclose(res.t_sec, pos / 1000.0, atol=1e-9)


def test_chunk_log_reports_escalation_counters(clip, caplog):
    """Production telemetry: every resolved chunk logs one progress
    line with its start frame, the cumulative pair count and the
    cumulative pair rate."""
    import logging

    skel = make_skeleton(len(clip))
    with caplog.at_level(logging.INFO, logger="btcs_pnes_optical_flow"):
        pipeline.run_flow_stage(ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=32)
    chunk_lines = [r.getMessage() for r in caplog.records if "pairs done" in r.getMessage()]
    n_pairs = len(clip) - 1
    assert len(chunk_lines) == -(-n_pairs // 32)
    for k, line in enumerate(chunk_lines):
        done = min((k + 1) * 32, n_pairs)
        assert line.startswith(f"flow chunk @{k * 32}: {done} pairs done, ")
        assert line.endswith(" pairs/s cumulative")
