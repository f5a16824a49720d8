"""Cohort runner: many recordings → per-video metric tables.

BASELINE.json config 4 end to end: a cohort of videos runs through the
chunked flow pipeline with per-video error isolation (a video whose
decode or analysis fails NaN-fills its row instead of killing the
cohort — the reference would simply crash, SURVEY.md §5), then the PC1
and metric stages run batched across the whole cohort, and the result
is one summary row per video with the reference's column contract.

Execution shape (vs the reference's strictly serial three-script chain,
optical_flow.py:222-250):

- Stage A (flow) runs the videos through a 2-worker thread pool, so the
  host-side resolve/transfer of video i overlaps the decode + device
  dispatch of video i+1.
- Stage B (PC1) batches every (video, roi) waveform of equal length
  into ONE vmapped band-pass+PCA program.
- Stage C (metrics) uses the batched two-phase head
  (:func:`~btcs_pnes_optical_flow.models.metrics.pc1_metrics_batch`):
  two device round trips for the whole cohort instead of ~10 per row.

An optional ``mesh`` shards stage A's device work over the video axis
(see :func:`cohort_flow_sharded`) when the cohort is uniform ndarray
clips; stages B/C are already one batched program each, which XLA
shards from the same mesh placement.
"""

from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from btcs_pnes_optical_flow.config import PipelineConfig
from btcs_pnes_optical_flow.dataio import contracts
from btcs_pnes_optical_flow.models import metrics as metrics_model
from btcs_pnes_optical_flow.models import pipeline
from btcs_pnes_optical_flow.utils.timing import StageTimer

logger = logging.getLogger("btcs_pnes_optical_flow")


@dataclasses.dataclass
class CohortItem:
    name: str
    video: object                   # path or VideoSource or ndarray
    skeleton: contracts.Skeleton
    roi_polygons: Sequence[np.ndarray]


# Columns of the cohort table; "U" (text) widths are sized per table.
COHORT_COLUMNS = [
    ("video", "U"),
    ("roi", "i8"),
    ("PC1_source", "U"),
    ("window_sec", "f8"),
    ("PC1_area_0_10", "f8"),
    ("ADS_slope_0_10", "f8"),
    ("ADS_R2_0_10", "f8"),
    ("Kendall_tau_0_10", "f8"),
    ("Kendall_p_0_10", "f8"),
    ("Peak_n", "i8"),
    ("status", "i8"),
    ("error", "U"),
]


def _nan_row(item: CohortItem, r: int, window_sec: float, err: str) -> tuple:
    nan = float("nan")
    return (item.name, r, "pc1_dyn", float(window_sec), nan, nan, nan, nan, nan, 0, -1, err)


def _table(rows: List[tuple]) -> np.ndarray:
    """Rows → NumPy structured array (``table["status"]``-style access)."""
    dtype = [
        (name, kind + str(max([1] + [len(r[j]) for r in rows])) if kind == "U" else kind)
        for j, (name, kind) in enumerate(COHORT_COLUMNS)
    ]
    return np.array(rows, dtype=dtype)


def run_cohort(
    items: Sequence[CohortItem],
    config: PipelineConfig = PipelineConfig(),
    chunk_pairs: int = 32,
    out_csv: Optional[str] = None,
    checkpoint_root: Optional[str] = None,
    mesh=None,
    flow_workers: int = 2,
) -> np.ndarray:
    """Run the full pipeline for every recording; one summary row per
    (video, ROI), returned as a structured array with COHORT_COLUMNS.
    Failures are isolated per video."""
    timer = StageTimer()
    n = len(items)
    flows: List[Optional[pipeline.FlowStageResult]] = [None] * n
    errors: List[Optional[str]] = [None] * n

    # ---- Stage A: flow (decode + chunked device flow per video) -----
    def flow_one(i: int):
        item = items[i]
        try:
            ck = f"{checkpoint_root}/{item.name}" if checkpoint_root else None
            flows[i] = pipeline.run_flow_stage(
                item.video, item.skeleton, item.roi_polygons, config,
                chunk_pairs, checkpoint_dir=ck,
            )
        except Exception as e:  # per-video isolation
            logger.warning("cohort item %s failed: %s", item.name, e)
            errors[i] = f"{type(e).__name__}: {e}"

    with timer.timed("flow"):
        if mesh is not None:
            from btcs_pnes_optical_flow.parallel.cohort import cohort_flow_sharded

            done = cohort_flow_sharded(items, flows, config, chunk_pairs, mesh)
            rest = [i for i in range(n) if not done[i]]
        else:
            rest = list(range(n))
        if len(rest) > 1 and flow_workers > 1:
            with ThreadPoolExecutor(max_workers=flow_workers) as pool:
                list(pool.map(flow_one, rest))
        else:
            for i in rest:
                flow_one(i)
    timer.add_items("flow", sum(len(f.frame) for f in flows if f is not None))

    # ---- Stage B: PC1, batched over every (video, roi) waveform -----
    # Rows of equal length share one vmapped program (padding a PCA
    # window with NaN is NOT equivalent to a shorter input at the tail,
    # so batching never pads — it groups by exact length).
    row_of = []  # (video_idx, roi_idx) per batched row
    pc1_rows: List[Optional[np.ndarray]] = []
    t_rows: List[np.ndarray] = []
    with timer.timed("pc1"):
        by_len: dict = {}
        for i, f in enumerate(flows):
            if f is None:
                continue
            for r in range(f.vx.shape[1]):
                by_len.setdefault(f.vx.shape[0], []).append((i, r))
        for t_len, pairs in by_len.items():
            import jax.numpy as jnp

            vx = jnp.asarray(
                np.stack([flows[i].vx[:, r] for i, r in pairs]), jnp.float32
            )
            vy = jnp.asarray(
                np.stack([flows[i].vy[:, r] for i, r in pairs]), jnp.float32
            )
            from btcs_pnes_optical_flow.models.pc1 import pc1_from_flow_batch

            pc1 = np.asarray(pc1_from_flow_batch(vx, vy, config.pca))
            for k, (i, r) in enumerate(pairs):
                row_of.append((i, r))
                pc1_rows.append(pc1[k])
                t_rows.append(flows[i].t_sec)
    timer.add_items("pc1", len(row_of))

    # ---- Stage C: metrics, one batched two-phase head ---------------
    with timer.timed("metrics"):
        if row_of:
            cap = max(len(t) for t in t_rows)
            cap = -(-cap // 256) * 256  # bucket: stable compile shapes
            t_mat = np.full((len(row_of), cap), np.nan, np.float32)
            p_mat = np.full((len(row_of), cap), np.nan, np.float32)
            for k, (t, p) in enumerate(zip(t_rows, pc1_rows)):
                t_mat[k, : len(t)] = t
                p_mat[k, : len(p)] = p
            mets = metrics_model.pc1_metrics_batch(t_mat, p_mat, config.metrics)
        else:
            mets = None
    timer.add_items("metrics", len(row_of))

    # ---- Row assembly (reference column contract) --------------------
    rows: List[tuple] = []
    by_key = {key: k for k, key in enumerate(row_of)}
    for i, item in enumerate(items):
        if flows[i] is None:
            for r in range(len(item.roi_polygons)):
                rows.append(_nan_row(item, r, config.metrics.window_sec, errors[i] or ""))
            continue
        for r in range(flows[i].vx.shape[1]):
            k = by_key[(i, r)]
            rows.append(
                (
                    item.name, r, "pc1_dyn", float(config.metrics.window_sec),
                    float(mets.pc1_area[k]), float(mets.ads_slope[k]),
                    float(mets.ads_r2[k]), float(mets.kendall_tau[k]),
                    float(mets.kendall_p[k]), int(mets.peak_n[k]),
                    int(mets.status[k]), "",
                )
            )
    logger.info("cohort rates: %s", timer.report())
    table = _table(rows)
    if out_csv is not None:
        contracts.write_csv(out_csv, {n: table[n] for n in table.dtype.names})
    return table
