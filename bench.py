"""Benchmark: ROI-frames/sec (flow + PCA) on the accelerator vs OpenCV-CPU.

BASELINE.md primary metric.  The workload is config 1 of BASELINE.json:
640×480@30fps frames, one upper-limb ROI, Farnebäck flow with the
reference FB_PARAMS → body-axis projection → ROI mean → band-pass +
sliding-window PCA.  The denominator is the reference's own compute
path (cv2.calcOpticalFlowFarneback per frame pair, single CPU process)
measured on the same clip.

Prints one JSON line per workload, primary last:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}
"""

import json
import os
import sys
import time

import numpy as np

from btcs_pnes_optical_flow.utils.compile_cache import enable_compile_cache

H, W = 480, 640
# Bigger chunks amortize per-dispatch overhead; the ladder falls back
# on out-of-memory.
CHUNK_LADDER = (256, 128, 64, 32)
N_PAIRS = 512          # device-timed pairs
CHUNK = CHUNK_LADDER[0]
# OpenCV-CPU denominator: the BEST cv2 fps across CPU_REPEATS runs of
# CPU_PAIRS pairs measured before the device region plus CPU_REPEATS
# runs immediately after it; both readings are recorded
# (cpu_fps_pre / cpu_fps_post).  Context only: it decides nothing.
CPU_PAIRS = 48
CPU_REPEATS = 3


def measure_cv2_fps(frames, roi, ex0, ey0, n_pairs, repeats, label="cv2"):
    """Best-of-`repeats` fps of the reference compute path
    (cv2.calcOpticalFlowFarneback + body projection + ROI nanmean,
    optical_flow.py:136-189) over the first `n_pairs` pairs."""
    try:
        import cv2
    except Exception as e:  # pragma: no cover
        print(f"# {label} baseline unavailable: {e}", file=sys.stderr)
        return None
    h, w = frames[0].shape
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [roi.astype(np.int32)], 1)
    maskb = mask.astype(bool)
    fb = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
              poly_n=5, poly_sigma=1.2, flags=0)
    cv2.calcOpticalFlowFarneback(frames[0], frames[1], None, **fb)  # warmup
    best = None
    for rep in range(repeats):
        t0 = time.perf_counter()
        for i in range(1, n_pairs + 1):
            fl = cv2.calcOpticalFlowFarneback(frames[i - 1], frames[i], None, **fb)
            fxb = fl[..., 0] * ex0[0] + fl[..., 1] * ex0[1]
            fyb = fl[..., 0] * ey0[0] + fl[..., 1] * ey0[1]
            mg = cv2.magnitude(fxb, fyb)
            _ = (np.nanmean(fxb[maskb]), np.nanmean(fyb[maskb]), np.nanmean(mg[maskb]))
        rep_fps = n_pairs / (time.perf_counter() - t0)
        best = rep_fps if best is None else max(best, rep_fps)
        print(f"# {label} repeat {rep}: {rep_fps:.2f} fps", file=sys.stderr)
    return best


def device_info():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def render_clip(n_frames, h=H, w=W, fps=30.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / fps
    cx = w * 0.5 + 40 * np.exp(-0.05 * t) * np.sin(2 * np.pi * 3.0 * t)
    cy = h * 0.5 + 18 * np.exp(-0.05 * t) * np.cos(2 * np.pi * 2.9 * t)
    yy, xx = np.mgrid[0:h, 0:w]
    texture = rng.normal(0, 6, (h, w))
    frames = np.empty((n_frames, h, w), np.uint8)
    for i in range(n_frames):
        blob = 150 * np.exp(-(((xx - cx[i]) / 30.0) ** 2 + ((yy - cy[i]) / 26.0) ** 2))
        frames[i] = np.clip(40 + texture + blob, 0, 255).astype(np.uint8)
    return frames


def main(chunk: int = None):
    chunk = chunk or CHUNK
    frames = render_clip(N_PAIRS + 1)
    roi = np.array([[140.0, 90.0], [520.0, 110.0], [500.0, 400.0], [120.0, 380.0]])
    theta = 0.3
    ex = np.tile(np.array([np.cos(theta), -np.sin(theta)], np.float32), (chunk, 1))
    ey = np.tile(np.array([np.sin(theta), np.cos(theta)], np.float32), (chunk, 1))

    # ---- OpenCV-CPU denominator, pre-device reading -------------------
    cpu_pre = measure_cv2_fps(frames, roi, ex[0], ey[0],
                              CPU_PAIRS, CPU_REPEATS, label="cv2-pre")

    # ---- device path ----------------------------------------------------
    import jax
    import jax.numpy as jnp

    from btcs_pnes_optical_flow.config import PipelineConfig
    from btcs_pnes_optical_flow.models.flow import roi_body_flow_seq
    from btcs_pnes_optical_flow.models.pc1 import pc1_from_flow
    from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask

    cfg = PipelineConfig()
    masks = jnp.asarray(fill_poly_mask(H, W, roi)[None])
    exd = jnp.asarray(ex)
    eyd = jnp.asarray(ey)

    # One (chunk+1)-frame array per chunk, staged before the clock; the
    # timed region covers all device compute + feature readback.
    chunks = [jnp.asarray(frames[s : s + chunk + 1]) for s in range(0, N_PAIRS, chunk)]
    jax.block_until_ready(roi_body_flow_seq(chunks[0], exd, eyd, masks, cfg.flow))

    t0 = time.perf_counter()
    # Dispatch every chunk first (async: compute of chunk k+1 overlaps
    # the readback of chunk k), then read all features back.
    pending = [roi_body_flow_seq(c, exd, eyd, masks, cfg.flow) for c in chunks]
    vx_h = np.concatenate([np.asarray(f.vx[:, 0]) for f in pending])
    vy_h = np.concatenate([np.asarray(f.vy[:, 0]) for f in pending])
    flow_time = time.perf_counter() - t0

    vx = jnp.asarray(np.concatenate([[np.nan], vx_h]).astype(np.float32))
    vy = jnp.asarray(np.concatenate([[np.nan], vy_h]).astype(np.float32))
    jax.block_until_ready(pc1_from_flow(vx, vy, cfg.pca))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(pc1_from_flow(vx, vy, cfg.pca))
    pca_time = time.perf_counter() - t0

    dev_fps = N_PAIRS / (flow_time + pca_time)

    # ---- OpenCV-CPU denominator, post-device reading ------------------
    cpu_post = measure_cv2_fps(frames, roi, ex[0], ey[0],
                               CPU_PAIRS, CPU_REPEATS, label="cv2-post")
    readings = [f for f in (cpu_pre, cpu_post) if f]
    cpu_fps = max(readings) if readings else None

    vs = (dev_fps / cpu_fps) if cpu_fps else float("nan")
    return json.dumps(
        {
            "metric": "ROI-frames/sec flow+PCA 640x480",
            "value": round(dev_fps, 2),
            "unit": "frames/sec",
            "vs_baseline": round(vs, 2) if vs == vs else None,
            "cpu_fps": round(cpu_fps, 2) if cpu_fps else None,
            "cpu_fps_pre": round(cpu_pre, 2) if cpu_pre else None,
            "cpu_fps_post": round(cpu_post, 2) if cpu_post else None,
            "cpu_pairs": CPU_PAIRS,
            "cpu_repeats": CPU_REPEATS,
            "chunk_pairs": chunk,
            "device": device_info(),
        }
    )


def bench_1080p():
    """BASELINE config 3: 1080p chunked streaming flow (secondary line),
    with its own cv2-CPU denominator (pre+post best-of, 8 pairs)."""
    import jax
    import jax.numpy as jnp

    from btcs_pnes_optical_flow.config import PipelineConfig
    from btcs_pnes_optical_flow.models.flow import roi_body_flow_seq
    from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask

    h, w, n_pairs = 1080, 1920, 96
    frames = render_clip(n_pairs + 1, h=h, w=w, seed=1)
    roi1080 = np.array([[420.0, 270.0], [1560.0, 330.0], [1500.0, 900.0], [360.0, 840.0]])
    th = 0.3
    ex0 = np.array([np.cos(th), -np.sin(th)], np.float32)
    ey0 = np.array([np.sin(th), np.cos(th)], np.float32)

    cpu_pairs = 8
    cpu_pre = measure_cv2_fps(frames, roi1080, ex0, ey0, cpu_pairs, 1,
                              label="cv2-1080p-pre")

    for chunk in (32, 16, 8):
        try:
            masks = jnp.asarray(fill_poly_mask(h, w, roi1080)[None])
            ex = jnp.asarray(np.tile(ex0, (chunk, 1)))
            ey = jnp.asarray(np.tile(ey0, (chunk, 1)))
            params = PipelineConfig().flow
            chunks = [jnp.asarray(frames[s : s + chunk + 1]) for s in range(0, n_pairs, chunk)]

            jax.block_until_ready(roi_body_flow_seq(chunks[0], ex, ey, masks, params))
            t0 = time.perf_counter()
            feats = [roi_body_flow_seq(c, ex, ey, masks, params) for c in chunks]
            jax.block_until_ready(feats)
            fps = n_pairs / (time.perf_counter() - t0)
            cpu_post = measure_cv2_fps(frames, roi1080, ex0, ey0, cpu_pairs, 1,
                                       label="cv2-1080p-post")
            readings = [f for f in (cpu_pre, cpu_post) if f]
            cpu_fps = max(readings) if readings else None
            vs = (fps / cpu_fps) if cpu_fps else None
            print(
                json.dumps(
                    {
                        "metric": "flow 1920x1080 streaming",
                        "value": round(fps, 2),
                        "unit": "frames/sec",
                        "vs_baseline": round(vs, 2) if vs else None,
                        "cpu_fps": round(cpu_fps, 3) if cpu_fps else None,
                        "cpu_fps_pre": round(cpu_pre, 3) if cpu_pre else None,
                        "cpu_fps_post": round(cpu_post, 3) if cpu_post else None,
                        "cpu_pairs": cpu_pairs,
                        "chunk_pairs": chunk,
                        "device": device_info(),
                    }
                )
            )
            return
        except Exception as e:
            print(f"# 1080p chunk {chunk} failed ({type(e).__name__}: {e}); retrying smaller", file=sys.stderr)
    print("# 1080p bench failed at all chunk sizes", file=sys.stderr)


def bench_cohort():
    """BASELINE config 4: 32-video cohort through the full pipeline
    (flow+PC1+metrics, per-video isolation) — secondary line."""
    from btcs_pnes_optical_flow.dataio import contracts
    from btcs_pnes_optical_flow.parallel.runner import CohortItem, run_cohort

    n_videos, n_frames = 32, 129
    roi = np.array([[140.0, 90.0], [520.0, 110.0], [500.0, 400.0], [120.0, 380.0]])
    items = []
    for v in range(n_videos):
        clip = render_clip(n_frames, seed=10 + v)
        t = np.arange(n_frames) / 30.0
        theta = 0.3
        ex = np.tile(np.array([np.cos(theta), -np.sin(theta)]), (n_frames, 1))
        ey = np.tile(np.array([np.sin(theta), np.cos(theta)]), (n_frames, 1))
        skel = contracts.Skeleton(time_all=t, ex=ex, ey=ey, fps=30.0)
        items.append(
            CohortItem(
                name=f"v{v}", video=clip, skeleton=skel,
                roi_polygons=[roi],
            )
        )

    # Production cohort execution: the video axis on a one-device mesh
    # — each cohort chunk is ONE dispatched program, and the
    # PC1/metric heads run batched across the cohort (parallel/runner).
    from btcs_pnes_optical_flow.parallel.mesh import make_mesh

    mesh = make_mesh(1, axes=("data",))
    # Warmup at the SAME cohort shape (the sharded chunk program is
    # specialized on V): compile outside the timed region.
    run_cohort(items, chunk_pairs=128, mesh=mesh)
    t0 = time.perf_counter()
    df = run_cohort(items, chunk_pairs=128, mesh=mesh)
    dt = time.perf_counter() - t0
    total_frames = n_videos * n_frames
    assert int((df["status"] >= 0).sum()) == n_videos

    # Single-core reference-pipeline denominator: the full reference chain (cv2 flow loop → SciPy band-pass +
    # sliding PCA → metrics, via the tests/reference_impl.py oracle)
    # over ONE of the 32 clips, scaled per frame.
    cpu_fps = None
    try:
        import importlib.util as _ilu

        spec = _ilu.spec_from_file_location(
            "reference_impl",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "reference_impl.py"),
        )
        ref = _ilu.module_from_spec(spec)
        spec.loader.exec_module(ref)
        from scipy.signal import butter

        from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask

        it0 = items[0]
        clip_host = it0.video
        roi_mask = fill_poly_mask(clip_host.shape[1], clip_host.shape[2], roi)
        t0 = time.perf_counter()
        fdf = ref.ref_flow_stage(
            clip_host, it0.skeleton.time_all, it0.skeleton.fps,
            it0.skeleton.ex, it0.skeleton.ey, roi_mask,
        )
        sos = butter(4, [0.5 / 15.0, 5.0 / 15.0], btype="band", output="sos")
        vxf = ref.ref_bandpass_nanrobust(fdf["vx_body"].to_numpy(), sos)
        vyf = ref.ref_bandpass_nanrobust(fdf["vy_body"].to_numpy(), sos)
        pc1 = ref.ref_dynamic_pc1(fdf["t_sec"].to_numpy(), vxf, vyf)
        ref.ref_metrics(fdf["t_sec"].to_numpy(), pc1)
        cpu_fps = n_frames / (time.perf_counter() - t0)
        print(f"# reference-pipeline cohort denominator: {cpu_fps:.2f} fps",
              file=sys.stderr)
    except Exception as e:  # pragma: no cover
        print(f"# cohort cv2 denominator unavailable: {type(e).__name__}: {e}",
              file=sys.stderr)

    fps = total_frames / dt
    print(
        json.dumps(
            {
                "metric": "cohort end-to-end (flow+PC1+metrics)",
                "value": round(fps, 2),
                "unit": "frames/sec",
                "vs_baseline": round(fps / cpu_fps, 2) if cpu_fps else None,
                "cpu_fps": round(cpu_fps, 2) if cpu_fps else None,
                "cpu_videos": 1,
                "videos": n_videos,
                "device": device_info(),
            }
        )
    )


def bench_tvl1():
    """BASELINE config 5: TV-L1 variational flow at 640x480 (secondary
    line), best of 3 at epsilon=0 (the full static iteration count) and
    at the shipped early-exit epsilon."""
    import jax
    import jax.numpy as jnp

    from btcs_pnes_optical_flow.ops.tvl1 import TVL1Params, tvl1_flow

    n_pairs = 16
    frames = render_clip(n_pairs + 1, seed=2)
    prev = jnp.asarray(frames[:-1])
    curr = jnp.asarray(frames[1:])

    def best_of(params, reps=3):
        jax.block_until_ready(tvl1_flow(prev, curr, params))  # compile
        fps = None
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(tvl1_flow(prev, curr, params))
            r = n_pairs / (time.perf_counter() - t0)
            fps = r if fps is None else max(fps, r)
        return fps

    full_fps = best_of(TVL1Params(epsilon=0.0))
    shipped_fps = best_of(TVL1Params())
    print(
        json.dumps(
            {
                "metric": "TV-L1 flow 640x480 (epsilon=0)",
                "value": round(full_fps, 2),
                "unit": "frames/sec",
                "vs_baseline": None,
                "earlyexit_fps": round(shipped_fps, 2),
                "device": device_info(),
            }
        )
    )


if __name__ == "__main__":
    # The primary measurement runs FIRST (cleanest machine state) but its
    # JSON line is printed LAST, after the secondary lines.  Everything
    # runs in this one process: one process per card.
    enable_compile_cache()
    primary_line = None
    for ck in CHUNK_LADDER:
        try:
            primary_line = main(ck)
            break
        except Exception as e:  # OOM etc. → retry with a smaller chunk
            print(f"# chunk {ck} failed ({type(e).__name__}); retrying smaller", file=sys.stderr)
    if primary_line is None:
        raise SystemExit(1)
    # Secondary lines: BASELINE configs 3 (1080p streaming), 5 (TV-L1)
    # and 4 (cohort end-to-end).
    if os.environ.get("BENCH_SECONDARY", "1") != "0":
        for secondary in (bench_1080p, bench_tvl1, bench_cohort):
            try:
                secondary()
            except Exception as e:
                print(f"# {secondary.__name__} failed: {type(e).__name__}: {e}", file=sys.stderr)
    print(primary_line)
