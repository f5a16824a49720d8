"""End-to-end pipeline: video → flow features → PC1 → metrics.

The reference runs three separate processes handing off CSVs
(SURVEY.md §3.4).  Here the full chain is one host-side orchestrator
around jit-compiled stages: chunked decode (prefetch thread) → batched
Farnebäck flow + ROI reduction on device → band-pass + sliding-window
PCA → metric head.  CSV emission at each boundary is optional, for
artifact compatibility with the reference scripts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from btcs_pnes_optical_flow.config import PipelineConfig
from btcs_pnes_optical_flow.dataio import contracts
from btcs_pnes_optical_flow.dataio.video import ChunkPrefetcher, VideoSource, open_source
from btcs_pnes_optical_flow.models import metrics as metrics_model
from btcs_pnes_optical_flow.models import pc1 as pc1_model
from btcs_pnes_optical_flow.models.flow import roi_body_flow_seq, skel_indices
from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask
from btcs_pnes_optical_flow.utils.timing import logger

# How many dispatched chunks may be in flight before the oldest one is
# forced to completion: keeps decode / device compute / host collection
# overlapped while bounding host RAM to ~depth+1 chunks of frames.
_PIPELINE_DEPTH = 2


@dataclasses.dataclass
class FlowStageResult:
    frame: np.ndarray      # (T,)
    t_sec: np.ndarray      # (T,)
    skel_idx: np.ndarray   # (T,)
    axes_ok: np.ndarray    # (T,) bool
    vx: np.ndarray         # (T, R)
    vy: np.ndarray         # (T, R)
    mag: np.ndarray        # (T, R)

    def columns(self, roi: int = 0) -> Dict[str, np.ndarray]:
        """flow.csv columns of one ROI (reference contract)."""
        return contracts.flow_columns(
            self.frame, self.t_sec, self.skel_idx, self.axes_ok.astype(int),
            self.vx[:, roi], self.vy[:, roi], self.mag[:, roi],
        )


def run_flow_stage(
    video,
    skeleton: contracts.Skeleton,
    roi_polygons: Sequence[np.ndarray],
    config: PipelineConfig = PipelineConfig(),
    chunk_pairs: int = 64,
    out_csv: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
) -> FlowStageResult:
    """Stage A: video + body axes + ROIs → per-frame flow features.

    Behavioral clone of run_body_axis_flow_core (optical_flow.py:
    195-259), chunked and batched: frame 0 and frames with invalid
    axes produce NaN features; each valid frame i uses the dense flow
    of the pair (i-1, i) projected on frame i's axes.
    """
    src = video if isinstance(video, VideoSource) else open_source(video, fps=skeleton.fps)
    h, w = src.height, src.width
    roi_masks = np.stack([fill_poly_mask(h, w, p) for p in roi_polygons])
    masks_dev = jnp.asarray(roi_masks)
    n_roi = len(roi_polygons)

    store = None
    if checkpoint_dir is not None:
        from btcs_pnes_optical_flow.dataio.checkpoint import ChunkStore

        store = ChunkStore(
            checkpoint_dir,
            meta={"chunk_pairs": chunk_pairs, "n_roi": n_roi, "h": h, "w": w},
        )

    rows_t: List[np.ndarray] = []
    feats_vx: List[np.ndarray] = []
    feats_vy: List[np.ndarray] = []
    feats_mag: List[np.ndarray] = []
    pair_valid: List[np.ndarray] = []

    # Chunks are dispatched asynchronously (device work for chunk k
    # overlaps decode of chunk k+1 via the prefetcher and JAX's async
    # dispatch) and resolved _PIPELINE_DEPTH chunks behind.
    pending = []

    all_pos: List[Optional[float]] = []
    n_frames = 0
    t_start = time.perf_counter()
    pairs_done = 0

    def resolve(entry):
        nonlocal pairs_done
        first, n_pairs, valid, t_chunk, sk, ok, feats = entry
        if valid is None:  # resumed from checkpoint
            vx, vy, mg = feats["vx"], feats["vy"], feats["mag"]
        else:
            vx = np.array(feats.vx)[:n_pairs]
            vy = np.array(feats.vy)[:n_pairs]
            mg = np.array(feats.mag)[:n_pairs]
            inv = ~valid[:n_pairs]
            vx[inv] = np.nan
            vy[inv] = np.nan
            mg[inv] = np.nan
            if store is not None:
                store.save(first, vx=vx, vy=vy, mag=mg, t=t_chunk, skel=sk, ok=ok)
        feats_vx.append(vx)
        feats_vy.append(vy)
        feats_mag.append(mg)
        rows_t.append(t_chunk)
        pair_valid.append(ok)
        pairs_done += n_pairs
        dt = time.perf_counter() - t_start
        logger.info(
            "flow chunk @%d: %d pairs done, %.1f pairs/s cumulative",
            first, pairs_done, pairs_done / dt if dt > 0 else 0.0,
        )

    for first, frames, pos in ChunkPrefetcher(src, chunk_pairs):
        if first == 0:
            all_pos.extend(pos)
        else:
            all_pos.extend(pos[1:])
        n_frames = first + len(frames)
        n_pairs = len(frames) - 1
        if n_pairs <= 0:
            continue
        # Static chunk shape: pad the tail chunk by repeating the last
        # frame (padded pairs are masked out afterwards).
        if n_pairs < chunk_pairs:
            reps = np.repeat(frames[-1:], chunk_pairs - n_pairs, axis=0)
            frames = np.concatenate([frames, reps], axis=0)
        # Timestamps/axes for the *current* frames of each pair.
        idxs = first + 1 + np.arange(chunk_pairs)
        idxs = np.minimum(idxs, n_frames - 1)
        pos_arr = np.array(
            [p if p is not None else -1.0 for p in (pos + [None] * (chunk_pairs + 1 - len(pos)))],
            dtype=np.float64,
        )
        # Per-frame timestamp rule of frame_time_sec (optical_flow.py:
        # 110-119): container POS_MSEC when positive, else frame/fps.
        fallback = idxs / float(src.fps)
        t_chunk = np.where(pos_arr[1 : chunk_pairs + 1] > 0, pos_arr[1 : chunk_pairs + 1] / 1000.0, fallback)
        sk = skel_indices(t_chunk, skeleton.time_all)
        ex = skeleton.ex[sk]
        ey = skeleton.ey[sk]
        ok = np.isfinite(ex).all(axis=1) & np.isfinite(ey).all(axis=1)
        ex_safe = np.where(ok[:, None], ex, 0.0).astype(np.float32)
        ey_safe = np.where(ok[:, None], ey, 0.0).astype(np.float32)

        if store is not None and store.has(first):
            cached = store.load(first)
            pending.append((first, n_pairs, None, t_chunk[:n_pairs], sk[:n_pairs], ok[:n_pairs], cached))
        else:
            feats = roi_body_flow_seq(
                jnp.asarray(frames),
                jnp.asarray(ex_safe),
                jnp.asarray(ey_safe),
                masks_dev,
                config.flow,
            )
            valid = np.zeros(chunk_pairs, bool)
            valid[:n_pairs] = ok[:n_pairs]
            pending.append((first, n_pairs, valid, t_chunk[:n_pairs], sk[:n_pairs], ok[:n_pairs], feats))
        while len(pending) > _PIPELINE_DEPTH:
            resolve(pending.pop(0))

    for entry in pending:
        resolve(entry)

    # Frame 0 row (no pair → NaN features), reference optical_flow.py:236-247.
    pos_all = np.array([p if p is not None else -1.0 for p in all_pos], dtype=np.float64)
    t0 = pos_all[0] / 1000.0 if len(pos_all) and pos_all[0] > 0 else 0.0
    t_sec = np.concatenate([[t0]] + rows_t) if rows_t else np.array([t0])
    frame_idx = np.arange(n_frames)
    sk_all = skel_indices(t_sec, skeleton.time_all)
    ex_all = skeleton.ex[sk_all]
    ey_all = skeleton.ey[sk_all]
    axes_ok = np.isfinite(ex_all).all(axis=1) & np.isfinite(ey_all).all(axis=1)

    nanrow = np.full((1, n_roi), np.nan)
    vx = np.concatenate([nanrow] + feats_vx) if feats_vx else nanrow
    vy = np.concatenate([nanrow] + feats_vy) if feats_vy else nanrow
    mag = np.concatenate([nanrow] + feats_mag) if feats_mag else nanrow

    res = FlowStageResult(
        frame=frame_idx,
        t_sec=t_sec,
        skel_idx=sk_all,
        axes_ok=axes_ok,
        vx=vx,
        vy=vy,
        mag=mag,
    )
    if out_csv is not None:
        contracts.write_csv(out_csv, res.columns(0))
    return res


def run_pc1_stage(
    flow: FlowStageResult,
    config: PipelineConfig = PipelineConfig(),
    out_csv: Optional[str] = None,
    engine: str = "scan",
) -> np.ndarray:
    """Stage B: flow features → pc1_dyn per ROI ((T, R))."""
    vx = jnp.asarray(flow.vx.T, jnp.float32)  # (R, T)
    vy = jnp.asarray(flow.vy.T, jnp.float32)
    pc1 = np.asarray(pc1_model.pc1_from_flow_batch(vx, vy, config.pca, engine=engine)).T
    if out_csv is not None:
        contracts.write_csv(out_csv, contracts.pc1_columns(flow.t_sec, pc1[:, 0]))
    return pc1


def run_metrics_stage(
    t_sec: np.ndarray,
    pc1: np.ndarray,
    config: PipelineConfig = PipelineConfig(),
    out_csv: Optional[str] = None,
    strict: bool = False,
):
    """Stage C: pc1 waveform(s) → metric row(s) (list over ROIs)."""
    pc1 = np.atleast_2d(pc1.T).T if pc1.ndim == 1 else pc1
    out = []
    for r in range(pc1.shape[1]):
        out.append(metrics_model.pc1_metrics(t_sec, pc1[:, r], config.metrics, strict=strict))
    if out_csv is not None:
        contracts.write_csv(
            out_csv, contracts.summary_columns(out[0], config.metrics.window_sec)
        )
    return out


def run_full(
    video,
    skeleton: contracts.Skeleton,
    roi_polygons: Sequence[np.ndarray],
    config: PipelineConfig = PipelineConfig(),
    chunk_pairs: int = 64,
    flow_csv: Optional[str] = None,
    pc1_csv: Optional[str] = None,
    summary_csv: Optional[str] = None,
):
    """video + skeleton + ROIs → (flow, pc1, metrics)."""
    flow = run_flow_stage(video, skeleton, roi_polygons, config, chunk_pairs, flow_csv)
    pc1 = run_pc1_stage(flow, config, pc1_csv)
    mets = run_metrics_stage(flow.t_sec, pc1, config, summary_csv)
    return flow, pc1, mets
