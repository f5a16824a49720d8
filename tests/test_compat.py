"""Compat entry points: the reference's three-script file pipeline.

Runs `optical_flow → optical_PCA → optical_PC1` through actual CSV/NPZ
artifacts, like the reference pipeline does (SURVEY.md §3.4) — and
verifies the final summary against the behavior oracle.  Note the
reference's own optical_PC1.py cannot run at all (three undefined
functions); this pipeline can.
"""

import numpy as np
import pandas as pd
import pytest

from btcs_pnes_optical_flow.compat import optical_PC1, optical_PCA, optical_flow
from btcs_pnes_optical_flow.dataio import contracts
from tests import reference_impl as ri
from tests.test_pipeline import ROI, make_skeleton, render_clip


def test_three_script_pipeline(tmp_path, rng):
    clip = render_clip(n_frames=96)
    skel = make_skeleton(len(clip))
    npz = str(tmp_path / "skeleton_pc1.npz")
    contracts.save_skeleton_npz(npz, skel)
    video = str(tmp_path / "clip.npy")
    np.save(video, clip)

    flow_csv = str(tmp_path / "flow.csv")
    pc1_csv = str(tmp_path / "flow_pc1.csv")
    sum_csv = str(tmp_path / "flow_summary_dyn_core.csv")

    # Stage A (script 1): video + npz + ROI → flow.csv
    optical_flow.run_body_axis_flow_core(video, npz, ROI, flow_csv)
    df = pd.read_csv(flow_csv)
    assert list(df.columns) == contracts.FLOW_COLUMNS
    assert len(df) == len(clip)
    assert np.isnan(df["vx_body"].iloc[0])  # frame 0 has no pair

    # Stage B (script 2): flow.csv → flow_pc1.csv
    optical_PCA.main([flow_csv, pc1_csv])
    dp = pd.read_csv(pc1_csv)
    assert list(dp.columns) == contracts.PC1_COLUMNS

    # Cross-check stage B against the oracle on the same flow.csv.
    import scipy.signal

    sos = scipy.signal.butter(4, [0.5 / 15, 5.0 / 15], btype="band", output="sos")
    vxf = ri.ref_bandpass_nanrobust(df["vx_body"].to_numpy(), sos)
    vyf = ri.ref_bandpass_nanrobust(df["vy_body"].to_numpy(), sos)
    ref_pc1 = ri.ref_dynamic_pc1(df["t_sec"].to_numpy(), vxf, vyf)
    mine = dp["pc1_dyn"].to_numpy()
    fin = np.isfinite(ref_pc1)
    assert np.array_equal(np.isnan(mine), np.isnan(ref_pc1))
    assert np.corrcoef(mine[fin], ref_pc1[fin])[0, 1] > 0.999

    # Stage C (script 3): flow_pc1.csv → one-row summary
    # (window shortened via module constant, mirroring how the
    # reference would be edited for a short clip).
    old = optical_PC1.WINDOW_SEC
    optical_PC1.WINDOW_SEC = 3.0
    try:
        optical_PC1.main([pc1_csv, sum_csv])
    finally:
        optical_PC1.WINDOW_SEC = old
    ds = pd.read_csv(sum_csv)
    assert list(ds.columns) == contracts.SUMMARY_COLUMNS
    assert len(ds) == 1
    assert ds["PC1_source"].iloc[0] == "pc1_dyn"


def test_compat_helpers_match_reference_semantics(rng):
    assert optical_PC1.ensure_odd(6) == 7 and optical_PC1.ensure_odd(7) == 7
    t = np.arange(120) / 29.97
    assert abs(optical_PC1.estimate_fs_from_time(t) - 29.97) < 0.05
    assert optical_flow.skel_index_from_time(0.5, np.array([0.0, 0.4, 0.6])) == 1
    assert optical_flow.frame_time_sec(1500.0, 7, 30.0) == 1.5
    assert optical_flow.frame_time_sec(None, 7, 30.0) == pytest.approx(7 / 30)
    w = optical_PCA.align_axis_to_ref(np.array([0.0, -1.0]))
    np.testing.assert_allclose(w, [0.0, 1.0])
