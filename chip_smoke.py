"""Smoke run of the whole system on one GPU: video → flow → PC1 → metrics.

    python chip_smoke.py                 # main path on one card
    python chip_smoke.py --four-cards    # cohort over a 4-card "data" mesh
    python chip_smoke.py --profile DIR   # main path + per-stage device trace

Main path: a 20 s, 640×480, 30 fps recording made from ``--seed`` (a
textured limb in clonic motion over a textured background) is written as
Y4M and run through ``pipeline.run_full`` and the ``compat.optical_flow``
CLI.  Eight of its pairs are then run through the same jitted
``farneback_flow`` on the GPU and on JAX's CPU backend, and the GPU's
flow features go through the NumPy/SciPy oracle in
``tests/reference_impl.py`` for PC1 and the metrics.

``--four-cards`` runs only the cohort path: 8 videos through
``run_cohort`` on a 4-device mesh against ``run_cohort`` on one card.

Exits non-zero, with no result line, when JAX finds no GPU or any check
fails.  The last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W, FPS = 480, 640, 30.0
N_FRAMES = 600           # 20 s: full 0-10 s metric window and 2 s PCA windows
CHUNK_PAIRS = 64
N_COMPARE_PAIRS = 8
# Flow contract against the CPU-backend run of the same pairs (max EPE
# inside the ROI), and a diagnostic bound on the mean: both backends run
# the same float32 program, so they differ only by summation order and
# FMA contraction (~1e-6 px); 1e-3 px leaves room for the few
# ill-conditioned pixels where the regularized 2x2 solve amplifies it.
MAX_EPE_PX = 0.1
MEAN_EPE_DIAG_PX = 1e-3
# ROI means average ~30k pixels, so float noise cancels; a TF32 product
# in the reduction would show up at ~1e-3 px.
ROI_MEAN_TOL_PX = 1e-4
PC1_MIN_CORR = 0.999
AUC_REL_TOL = 1e-2
# Cohort metrics, sharded vs one card: the two paths fuse the same flow
# program differently, so ROI means differ by float noise (~1e-6 px);
# the ln-amplitude regression passes that on at about the same size.
METRIC_REL_TOL = 1e-4

LIMB_CENTER = (400.0, 240.0)
LIMB_AXES = (90.0, 40.0)
LIMB_ANGLE = 0.5         # radians; also the direction of motion
ROI_HALF = (120.0, 70.0)  # limb-frame half extents of the ROI rectangle


def render_recording(seed: int, n_frames: int, h: int = H, w: int = W,
                     fps: float = FPS) -> np.ndarray:
    """(T, H, W) uint8: a textured elliptic limb oscillating along its
    long axis over a static textured background, with decaying
    amplitude and slowing rhythm (clonic slowing)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    background = (128 + 40 * np.sin(xx / 5.3) * np.cos(yy / 6.1)
                  + 25 * np.sin((xx + 2 * yy) / 9.7) + rng.normal(0, 3, (h, w)))
    t = np.arange(n_frames) / fps
    phase0 = rng.uniform(0, 2 * np.pi)
    disp = 6.0 * np.exp(-0.08 * t) * np.sin(2 * np.pi * (3.5 * t - 0.05 * t * t) + phase0)
    ca, sa = np.cos(LIMB_ANGLE), np.sin(LIMB_ANGLE)
    scale = min(h / H, w / W)
    cx, cy = LIMB_CENTER[0] * w / W, LIMB_CENTER[1] * h / H
    a, b = LIMB_AXES[0] * scale, LIMB_AXES[1] * scale
    r = int(a + 12)
    y0, y1 = max(0, int(cy) - r), min(h, int(cy) + r)
    x0, x1 = max(0, int(cx) - r), min(w, int(cx) + r)
    bx, by = xx[y0:y1, x0:x1], yy[y0:y1, x0:x1]
    frames = np.empty((n_frames, h, w), np.uint8)
    base = np.clip(background, 0, 255).astype(np.uint8)
    for i in range(n_frames):
        px = bx - cx - disp[i] * ca
        py = by - cy - disp[i] * sa
        u = px * ca + py * sa
        v = -px * sa + py * ca
        alpha = np.clip((1.0 - (u / a) ** 2 - (v / b) ** 2) / 0.15 + 0.5, 0.0, 1.0)
        limb = 128 + 55 * np.sin(u / 4.3) * np.cos(v / 3.7) + 30 * np.sin((u - 2 * v) / 8.9)
        frames[i] = base
        patch = background[y0:y1, x0:x1] * (1 - alpha) + limb * alpha
        frames[i, y0:y1, x0:x1] = np.clip(patch, 0, 255).astype(np.uint8)
    return frames


def roi_polygon(h: int = H, w: int = W) -> np.ndarray:
    """Upper-limb ROI: the limb's rectangle, widened by its motion."""
    scale = min(h / H, w / W)
    cx, cy = LIMB_CENTER[0] * w / W, LIMB_CENTER[1] * h / H
    ca, sa = np.cos(LIMB_ANGLE), np.sin(LIMB_ANGLE)
    hu, hv = ROI_HALF[0] * scale, ROI_HALF[1] * scale
    corners = [(-hu, -hv), (hu, -hv), (hu, hv), (-hu, hv)]
    return np.array([[cx + u * ca - v * sa, cy + u * sa + v * ca] for u, v in corners])


def make_skeleton(n_frames: int, fps: float = FPS, nan_rows=((100, 105), (450, 453))):
    """Body axes turning slowly, with a few rows of missing keypoints."""
    from btcs_pnes_optical_flow.dataio import contracts

    t = np.arange(n_frames) / fps
    theta = 0.3 + 0.2 * np.sin(2 * np.pi * 0.05 * t)
    ex = np.stack([np.cos(theta), -np.sin(theta)], axis=1)
    ey = np.stack([np.sin(theta), np.cos(theta)], axis=1)
    for s, e in nan_rows:
        ex[s:e] = np.nan
        ey[s:e] = np.nan
    return contracts.Skeleton(time_all=t, fps=fps, ex=ex, ey=ey)


def write_y4m(path: str, frames: np.ndarray, fps: float = FPS) -> None:
    _, h, w = frames.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 Cmono\n".encode())
        for fr in frames:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())


def check(ok: bool, what: str) -> None:
    print(f"check {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise AssertionError(what)


def epe_stats(a: np.ndarray, b: np.ndarray, mask: np.ndarray):
    """(max, mean) end-point error between two (..., H, W, 2) flow
    fields over the pixels where the (H, W) mask is set."""
    epe = np.sqrt(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).sum(-1))
    sel = epe[..., mask]
    return float(sel.max()), float(sel.mean())


def oracle_compare(t_sec: np.ndarray, vx: np.ndarray, vy: np.ndarray,
                   pc1: np.ndarray, mets, window_sec: float = 10.0):
    """PC1 and metrics of the pipeline against the NumPy/SciPy oracle
    fed the same flow features.  Returns (pc1 correlation, NaN masks
    equal, {metric: (ours, oracle)})."""
    import importlib.util

    import scipy.signal

    # By path: another installed package may own the name "tests".
    spec = importlib.util.spec_from_file_location(
        "reference_impl",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "reference_impl.py"),
    )
    ri = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ri)

    sos = scipy.signal.butter(4, [0.5 / 15.0, 5.0 / 15.0], btype="band", output="sos")
    ref_pc1 = ri.ref_dynamic_pc1(t_sec, ri.ref_bandpass_nanrobust(vx, sos),
                                 ri.ref_bandpass_nanrobust(vy, sos))
    fin = np.isfinite(ref_pc1) & np.isfinite(pc1)
    corr = float(np.corrcoef(pc1[fin], ref_pc1[fin])[0, 1])
    same_nan = bool(np.array_equal(np.isnan(pc1), np.isnan(ref_pc1)))
    ref_m = ri.ref_metrics(t_sec, ref_pc1, window_sec=window_sec)
    pairs = {
        "PC1_area_0_10": (float(mets.pc1_area), ref_m["PC1_area_0_10"]),
        "ADS_slope_0_10": (float(mets.ads_slope), ref_m["ADS_slope_0_10"]),
        "Kendall_tau_0_10": (float(mets.kendall_tau), ref_m["Kendall_tau_0_10"]),
        "Peak_n": (int(mets.peak_n), ref_m["Peak_n"]),
    }
    return corr, same_nan, pairs


def nvidia_smi_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def main_phase(seed: int, workdir: str, n_frames: int = N_FRAMES,
               h: int = H, w: int = W, chunk_pairs: int = CHUNK_PAIRS):
    """run_full and the compat CLI on a Y4M recording; returns what the
    comparison phase needs."""
    from btcs_pnes_optical_flow.compat import optical_flow as compat_flow
    from btcs_pnes_optical_flow.dataio import contracts
    from btcs_pnes_optical_flow.models import pipeline
    from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask

    t0 = time.perf_counter()
    frames = render_recording(seed, n_frames, h, w)
    video = os.path.join(workdir, "recording.y4m")
    write_y4m(video, frames)
    skel = make_skeleton(n_frames)
    npz = os.path.join(workdir, "skeleton_pc1.npz")
    contracts.save_skeleton_npz(npz, skel)
    roi = roi_polygon(h, w)
    mask = fill_poly_mask(h, w, roi)
    print(f"recording: {n_frames} frames {w}x{h} @ {FPS:g} fps, seed {seed}, "
          f"ROI {mask.mean() * 100:.1f}% of the frame, made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    csvs = {k: os.path.join(workdir, f"{k}.csv") for k in ("flow", "flow_pc1", "summary")}
    n_pairs = n_frames - 1
    walls = []
    for _ in range(2):  # the first run compiles, the second is warm
        t0 = time.perf_counter()
        flow, pc1, mets = pipeline.run_full(
            video, skel, [roi], chunk_pairs=chunk_pairs, flow_csv=csvs["flow"],
            pc1_csv=csvs["flow_pc1"], summary_csv=csvs["summary"],
        )
        walls.append(time.perf_counter() - t0)
    print(f"run_full: cold {walls[0]:.3f} s, warm {walls[1]:.3f} s "
          f"({n_pairs / walls[1]:.2f} pairs/s warm, decode included), "
          f"compile ~{walls[0] - walls[1]:.3f} s", flush=True)

    flow_cols = contracts.read_flow_csv(csvs["flow"])
    pc1_cols = contracts.read_pc1_csv(csvs["flow_pc1"])
    summ = contracts.read_csv(csvs["summary"])
    check(list(flow_cols) == contracts.FLOW_COLUMNS and len(flow_cols["t_sec"]) == n_frames,
          f"flow.csv has the contract columns and {n_frames} rows")
    check(list(pc1_cols) == contracts.PC1_COLUMNS and len(pc1_cols["t_sec"]) == n_frames,
          f"flow_pc1.csv has the contract columns and {n_frames} rows")
    check(list(summ) == contracts.SUMMARY_COLUMNS and len(summ["Peak_n"]) == 1,
          "flow_summary csv has the contract columns and one row")
    live = flow.axes_ok.copy()
    live[0] = False
    check(bool(np.isfinite(flow.vx[live]).all() and np.isnan(flow.vx[~live]).all()),
          "flow features finite exactly where a pair has valid body axes")
    check(int(mets[0].status) == 0 and np.isfinite(float(mets[0].pc1_area)),
          f"metric head ran (status {int(mets[0].status)})")

    cli_csv = os.path.join(workdir, "flow_cli.csv")
    compat_flow.main([video, npz, cli_csv, json.dumps(roi.tolist())])
    cli = contracts.read_flow_csv(cli_csv)
    same = open(cli_csv, "rb").read() == open(csvs["flow"], "rb").read()
    check(all(np.allclose(cli[c], flow_cols[c], rtol=1e-6, atol=1e-9, equal_nan=True)
              for c in contracts.FLOW_COLUMNS),
          f"compat.optical_flow CLI flow.csv equals run_full's (byte-identical: {same})")
    return frames, skel, roi, mask, flow, pc1, mets


def comparison_phase(frames, skel, roi, mask, flow, pc1, mets, cpu_device):
    """GPU flow vs the CPU-backend run of the same jitted program, and
    the GPU's features through the NumPy/SciPy oracle."""
    import jax

    from btcs_pnes_optical_flow.models.flow import roi_body_flow
    from btcs_pnes_optical_flow.ops.farneback import farneback_flow

    # Eight pairs around the fastest motion of the first second.
    n = N_COMPARE_PAIRS
    first = int(np.argmax(np.nan_to_num(np.abs(flow.vx[1:31, 0])))) + 1
    first = max(1, min(first, len(frames) - n - 1))
    prev, curr = frames[first - 1 : first - 1 + n], frames[first : first + n]
    ex = np.asarray(skel.ex[first : first + n], np.float32)
    ey = np.asarray(skel.ey[first : first + n], np.float32)
    ex = np.where(np.isfinite(ex), ex, 0.0)
    ey = np.where(np.isfinite(ey), ey, 0.0)
    masks = mask[None]

    def run(device):
        args = [jax.device_put(x, device) for x in (prev, curr, ex, ey, masks)]
        fl = farneback_flow(args[0], args[1])
        feats = roi_body_flow(*args)
        return fl, feats

    gpu_device = jax.devices()[0]
    fl_gpu, f_gpu = run(gpu_device)
    fl_cpu, f_cpu = run(cpu_device)
    check(fl_gpu.devices() == {gpu_device} and f_gpu.vx.devices() == {gpu_device},
          f"flow outputs live on {gpu_device.platform}:{gpu_device.device_kind}")
    fl_gpu, fl_cpu = np.asarray(fl_gpu), np.asarray(fl_cpu)
    check(fl_gpu.shape == (n, frames.shape[1], frames.shape[2], 2)
          and bool(np.isfinite(fl_gpu).all()), f"GPU flow finite, shape {fl_gpu.shape}")
    e_max, e_mean = epe_stats(fl_gpu, fl_cpu, mask)
    print(f"flow GPU vs CPU backend, frames {first - 1}..{first + n - 1}, inside the ROI: "
          f"max EPE {e_max:.3e} px, mean EPE {e_mean:.3e} px "
          f"(diagnostic mean bound {MEAN_EPE_DIAG_PX:g} px: "
          f"{'within' if e_mean < MEAN_EPE_DIAG_PX else 'EXCEEDED'})", flush=True)
    check(e_max < MAX_EPE_PX, f"max EPE inside the ROI {e_max:.3e} < {MAX_EPE_PX} px")
    d_vx = float(np.abs(np.asarray(f_gpu.vx) - np.asarray(f_cpu.vx)).max())
    d_vy = float(np.abs(np.asarray(f_gpu.vy) - np.asarray(f_cpu.vy)).max())
    check(max(d_vx, d_vy) < ROI_MEAN_TOL_PX,
          f"ROI-mean vx/vy GPU vs CPU: max |d| {d_vx:.3e} / {d_vy:.3e} < {ROI_MEAN_TOL_PX:g} px")
    try:
        import cv2
    except ImportError:
        print("cv2 not importable: no OpenCV comparison (information only)")
    else:
        ref = np.stack([cv2.calcOpticalFlowFarneback(p, c, None, 0.5, 3, 15, 3, 5, 1.2, 0)
                        for p, c in zip(prev, curr)])
        c_max, c_mean = epe_stats(fl_gpu, ref, mask)
        print(f"information: GPU flow vs cv2.calcOpticalFlowFarneback inside the ROI: "
              f"max EPE {c_max:.3e} px, mean {c_mean:.3e} px")

    corr, same_nan, pairs = oracle_compare(flow.t_sec, flow.vx[:, 0], flow.vy[:, 0],
                                           pc1[:, 0], mets[0])
    for name, (ours, ref) in pairs.items():
        print(f"metric {name}: pipeline {ours!r} oracle {ref!r}")
    check(same_nan, "PC1 NaN positions equal the oracle's")
    check(corr >= PC1_MIN_CORR, f"PC1 correlation with the oracle {corr:.6f} >= {PC1_MIN_CORR}")
    ours, ref = pairs["PC1_area_0_10"]
    check(abs(ours - ref) <= AUC_REL_TOL * abs(ref),
          f"PC1 AUC within {AUC_REL_TOL:g} relative of the oracle")


def profile_phase(frames, roi, log_dir: str, chunk_pairs: int = CHUNK_PAIRS):
    """Trace the warm chunk step of the flow stage and print device time
    per stage."""
    import jax
    import jax.numpy as jnp

    from btcs_pnes_optical_flow.models.flow import roi_body_flow_seq
    from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask
    from btcs_pnes_optical_flow.utils.timing import FLOW_SCOPES, device_time_by_scope

    h, w = frames.shape[1:]
    chunk = jnp.asarray(frames[: chunk_pairs + 1])
    ex = jnp.tile(jnp.asarray([[np.cos(0.3), -np.sin(0.3)]], jnp.float32), (chunk_pairs, 1))
    ey = jnp.tile(jnp.asarray([[np.sin(0.3), np.cos(0.3)]], jnp.float32), (chunk_pairs, 1))
    masks = jnp.asarray(fill_poly_mask(h, w, roi)[None])
    jax.block_until_ready(roi_body_flow_seq(chunk, ex, ey, masks))
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(roi_body_flow_seq(chunk, ex, ey, masks))
    step = (time.perf_counter() - t0) / reps
    print(f"chunk step ({chunk_pairs} pairs {w}x{h}), profiler off: {step * 1e3:.3f} ms "
          f"= {chunk_pairs / step:.2f} pairs/s", flush=True)
    n_traced = 3
    with jax.profiler.trace(log_dir):
        for _ in range(n_traced):
            jax.block_until_ready(roi_body_flow_seq(chunk, ex, ey, masks))
    rep = device_time_by_scope(log_dir, FLOW_SCOPES)
    busy = max(rep["busy_ns"], 1)
    print(f"trace: {n_traced} chunk steps, window {rep['window_ns'] / 1e6:.3f} ms, "
          f"device busy {rep['busy_ns'] / 1e6:.3f} ms, idle share "
          f"{1 - rep['busy_ns'] / rep['window_ns']:.4f}, {rep['n_events']} kernels")
    for scope, ns in rep["by_scope"].items():
        print(f"stage {scope}: {ns / n_traced / 1e6:.3f} ms per chunk step "
              f"({ns / busy * 100:.1f}% of busy)")
    top = sorted(rep["by_op"].items(), key=lambda kv: -kv[1])[:12]
    for (scope, kind), ns in top:
        print(f"kernel {scope}/{kind}: {ns / n_traced / 1e6:.3f} ms per chunk step "
              f"({ns / busy * 100:.1f}% of busy)")


def four_card_phase(seed: int, n_cards: int = 4, n_videos: int = 8, n_frames: int = 129,
                    h: int = H, w: int = W, chunk_pairs: int = CHUNK_PAIRS):
    """run_cohort over an n-card "data" mesh against run_cohort on one
    card: per-video ROI means and metric rows must agree."""
    import jax

    from btcs_pnes_optical_flow.config import PipelineConfig
    from btcs_pnes_optical_flow.models import pipeline
    from btcs_pnes_optical_flow.parallel import cohort
    from btcs_pnes_optical_flow.parallel.mesh import make_mesh
    from btcs_pnes_optical_flow.parallel.runner import CohortItem, run_cohort

    check(len(jax.devices()) >= n_cards, f"{len(jax.devices())} devices >= {n_cards}")
    mesh = make_mesh(n_cards, axes=("data",))
    roi = roi_polygon(h, w)
    t0 = time.perf_counter()
    items = [
        CohortItem(name=f"v{v}", video=render_recording(seed + v, n_frames, h, w),
                   skeleton=make_skeleton(n_frames, nan_rows=((20 + v, 23 + v),)),
                   roi_polygons=[roi])
        for v in range(n_videos)
    ]
    print(f"cohort: {n_videos} videos of {n_frames} frames {w}x{h}, made in "
          f"{time.perf_counter() - t0:.2f} s; mesh {dict(mesh.shape)} over "
          f"{[str(d) for d in mesh.devices.flat]}", flush=True)
    cfg = PipelineConfig()

    walls = {}
    tables = {}
    for label, m in (("sharded", mesh), ("one card", None)):
        for rep in range(2):  # the first run compiles
            t0 = time.perf_counter()
            tables[label] = run_cohort(items, cfg, chunk_pairs=chunk_pairs, mesh=m)
            walls[label, rep] = time.perf_counter() - t0
        print(f"run_cohort {label}: cold {walls[label, 0]:.3f} s, warm {walls[label, 1]:.3f} s "
              f"({n_videos * n_frames / walls[label, 1]:.2f} frames/s warm)", flush=True)

    flows = [None] * n_videos
    done = cohort.cohort_flow_sharded(items, flows, cfg, chunk_pairs, mesh)
    check(all(done), "every video took the sharded flow path")
    d_max = 0.0
    for item, f4 in zip(items, flows):
        f1 = pipeline.run_flow_stage(item.video, item.skeleton, item.roi_polygons, cfg,
                                     chunk_pairs)
        for a, b in ((f4.vx, f1.vx), (f4.vy, f1.vy)):
            check(np.array_equal(np.isnan(a), np.isnan(b)), f"{item.name}: NaN rows equal")
            fin = np.isfinite(a)
            d_max = max(d_max, float(np.abs(a[fin] - b[fin]).max()))
    check(d_max < ROI_MEAN_TOL_PX,
          f"per-video ROI-mean vx/vy, {n_cards} cards vs one: max |d| {d_max:.3e} px")

    a, b = tables["sharded"], tables["one card"]
    check(a.dtype.names == b.dtype.names and len(a) == n_videos, "cohort tables have one row per video")
    for col in a.dtype.names:
        if a[col].dtype.kind == "f":
            rel = float(np.nanmax(np.abs(a[col] - b[col]) / np.maximum(np.abs(b[col]), 1e-12)))
            check(bool(np.array_equal(np.isnan(a[col]), np.isnan(b[col])))
                  and rel <= METRIC_REL_TOL,
                  f"cohort column {col}, {n_cards} cards vs one: max rel diff {rel:.3e}")
        else:
            check(bool(np.array_equal(a[col], b[col])),
                  f"cohort column {col} equal, {n_cards} cards vs one")
    check(bool((a["status"] == 0).all()), "every video's metric head ran")
    for row in a:
        print(f"cohort row {row['video']}: AUC {float(row['PC1_area_0_10'])!r} "
              f"ADS {float(row['ADS_slope_0_10'])!r} tau {float(row['Kendall_tau_0_10'])!r} "
              f"peaks {int(row['Peak_n'])}")

    # The chunk program itself: its output is sharded over every card.
    from jax.sharding import NamedSharding, PartitionSpec as P

    from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask

    data = NamedSharding(mesh, P("data"))
    fr = jax.device_put(np.stack([it.video[: chunk_pairs + 1] for it in items]), data)
    e = jax.device_put(np.zeros((n_videos, chunk_pairs, 2), np.float32), data)
    mk = jax.device_put(np.stack([fill_poly_mask(h, w, roi)[None]] * n_videos), data)
    out = cohort.cohort_chunk_step(mesh, cfg.flow)(fr, e, e, mk)
    check(len(out[0].sharding.device_set) == n_cards,
          f"sharded chunk output spans {len(out[0].sharding.device_set)} devices")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the cohort over a 4-card mesh against one card")
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace the chunk step into DIR and print device time per stage")
    args = ap.parse_args(argv)

    # The comparison runs the same program on JAX's CPU backend, so keep
    # that backend available next to the GPU.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1

    from btcs_pnes_optical_flow.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    print("card (nvidia-smi name, power.limit):")
    for line in nvidia_smi_lines():
        print(line)
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.platform} {dev.device_kind}",
          flush=True)

    if args.four_cards:
        four_card_phase(args.seed)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            out = main_phase(args.seed, workdir)
        frames, skel, roi, mask, flow, pc1, mets = out
        comparison_phase(frames, skel, roi, mask, flow, pc1, mets, jax.devices("cpu")[0])
        if args.profile:
            profile_phase(frames, roi, args.profile)

    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
