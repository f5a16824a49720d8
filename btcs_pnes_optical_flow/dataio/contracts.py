"""The reference pipeline's on-disk data contracts (SURVEY.md §2.5).

The stage boundaries of the reference are CSV/NPZ files; this module
keeps those formats alive as a compatibility layer so artifacts are
interchangeable between the reference scripts and this framework:

- ``skeleton_pc1.npz``: time_all (T,), fps, ex (T,2), ey (T,2)
  (optical_flow.py:20-30, 204-210).
- ``flow.csv``: frame, t_sec, skel_idx, axes_ok, vx_body, vy_body,
  mag_body (optical_flow.py:255-259).
- ``flow_pc1.csv``: t_sec, pc1_dyn (optical_PCA.py:270).
- ``flow_summary_dyn_core.csv``: single-row, 8 columns
  (optical_PC1.py:285-299).
"""

from __future__ import annotations

import csv
from typing import Dict, NamedTuple

import numpy as np


FLOW_COLUMNS = ["frame", "t_sec", "skel_idx", "axes_ok", "vx_body", "vy_body", "mag_body"]
PC1_COLUMNS = ["t_sec", "pc1_dyn"]
SUMMARY_COLUMNS = [
    "PC1_source",
    "window_sec",
    "PC1_area_0_10",
    "ADS_slope_0_10",
    "ADS_R2_0_10",
    "Kendall_tau_0_10",
    "Kendall_p_0_10",
    "Peak_n",
]


class Skeleton(NamedTuple):
    time_all: np.ndarray  # (T,)
    fps: float
    ex: np.ndarray        # (T, 2)
    ey: np.ndarray        # (T, 2)


def load_skeleton_npz(path: str) -> Skeleton:
    dat = np.load(path, allow_pickle=True)
    return Skeleton(
        time_all=np.asarray(dat["time_all"], dtype=float),
        fps=float(dat["fps"]),
        ex=np.asarray(dat["ex"], dtype=float),
        ey=np.asarray(dat["ey"], dtype=float),
    )


def save_skeleton_npz(path: str, skel: Skeleton) -> None:
    np.savez(path, time_all=skel.time_all, fps=skel.fps, ex=skel.ex, ey=skel.ey)


def write_csv(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write named columns as CSV, byte-identical to pandas'
    ``DataFrame(columns).to_csv(path, index=False)``: floats in their
    shortest round-trip form, NaN as an empty field, minimal quoting,
    ``\n`` line ends."""
    names = list(columns)
    texts = [_column_text(columns[n]) for n in names]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        writer.writerows(zip(*texts))


def _column_text(values) -> np.ndarray:
    v = np.asarray(values)
    text = v.astype(str).astype(object)
    if v.dtype.kind == "f":
        text[np.isnan(v)] = ""
    return text


def read_csv(path: str, required=()) -> Dict[str, np.ndarray]:
    """CSV → {column: array}.  Numeric columns (empty field = NaN)
    become float64, any other column an object array of strings."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    missing = [c for c in sorted(required) if c not in header]
    if missing:
        raise KeyError(
            f"Missing columns in {path}. Required={sorted(required)}, missing={missing}."
        )
    cols = {}
    for j, name in enumerate(header):
        raw = [r[j] if j < len(r) else "" for r in body]
        try:
            cols[name] = np.array([float(x) if x else np.nan for x in raw])
        except ValueError:
            cols[name] = np.array(raw, dtype=object)
    return cols


def flow_columns(
    frame_idx: np.ndarray,
    t_sec: np.ndarray,
    skel_idx: np.ndarray,
    axes_ok: np.ndarray,
    vx: np.ndarray,
    vy: np.ndarray,
    mag: np.ndarray,
) -> Dict[str, np.ndarray]:
    return {
        "frame": np.asarray(frame_idx, dtype=int),
        "t_sec": np.asarray(t_sec, dtype=float),
        "skel_idx": np.asarray(skel_idx, dtype=int),
        "axes_ok": np.asarray(axes_ok, dtype=int),
        "vx_body": np.asarray(vx, dtype=float),
        "vy_body": np.asarray(vy, dtype=float),
        "mag_body": np.asarray(mag, dtype=float),
    }


def read_flow_csv(path: str) -> Dict[str, np.ndarray]:
    return read_csv(path, {"t_sec", "vx_body", "vy_body"})


def pc1_columns(t_sec: np.ndarray, pc1_dyn: np.ndarray) -> Dict[str, np.ndarray]:
    return {"t_sec": np.asarray(t_sec, float), "pc1_dyn": np.asarray(pc1_dyn, float)}


def read_pc1_csv(path: str, pc1_col: str = "pc1_dyn") -> Dict[str, np.ndarray]:
    return read_csv(path, {"t_sec", pc1_col})


def summary_columns(
    metrics, window_sec: float = 10.0, source: str = "pc1_dyn"
) -> Dict[str, np.ndarray]:
    """One-row summary matching optical_PC1.py:285-299."""
    return {
        "PC1_source": np.array([source], dtype=object),
        "window_sec": np.array([float(window_sec)]),
        "PC1_area_0_10": np.array([float(metrics.pc1_area)]),
        "ADS_slope_0_10": np.array([float(metrics.ads_slope)]),
        "ADS_R2_0_10": np.array([float(metrics.ads_r2)]),
        "Kendall_tau_0_10": np.array([float(metrics.kendall_tau)]),
        "Kendall_p_0_10": np.array([float(metrics.kendall_p)]),
        "Peak_n": np.array([int(metrics.peak_n)]),
    }
