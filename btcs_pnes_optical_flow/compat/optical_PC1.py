"""Drop-in equivalent of the reference's optical_PC1.py entry point.

Same public surface (ensure_odd, smooth_ma_nan, rolling_p95_positive,
detect_cycles_positive_peaks — optical_PC1.py:47-228) plus working
implementations of the three functions the published script calls but
never defines (estimate_fs_from_time, safe_auc, exp_decay_regression;
optical_PC1.py:263,267,270 — specified in SURVEY.md §2.4), so this
entry point actually runs, which the reference as published does not.

Usage:  python -m btcs_pnes_optical_flow.compat.optical_PC1 \
            [flow_pc1.csv] [flow_summary_dyn_core.csv]
"""

from __future__ import annotations

import sys

import numpy as np

from btcs_pnes_optical_flow.config import MetricParams
from btcs_pnes_optical_flow.dataio import contracts
from btcs_pnes_optical_flow.models.metrics import pc1_metrics
from btcs_pnes_optical_flow.ops import peaks as _peaks
from btcs_pnes_optical_flow.ops import stats as _stats
from btcs_pnes_optical_flow.ops.filters import smooth_window_len

IN_CSV = "flow_pc1.csv"
OUT_CSV = "flow_summary_dyn_core.csv"
PC1_COL = "pc1_dyn"
WINDOW_SEC = 10.0
SMOOTH_SEC = 0.20
PEAK_MIN_FRAC = 0.20
PEAK_MIN_ABS = 0.0
MIN_DIST_SEC = 0.2


def ensure_odd(n: int) -> int:
    return int(n) | 1


def estimate_fs_from_time(time) -> float:
    """Sampling rate from timestamps: 1/median(Δt) (robust to jitter)."""
    import jax.numpy as jnp

    t = np.asarray(time, float)
    m = np.isfinite(t)
    return float(_stats.estimate_fs_masked(jnp.asarray(t, jnp.float32), jnp.asarray(m)))


def safe_auc(amp, time) -> float:
    """NaN-robust trapezoidal integral of amp(t)."""
    import jax.numpy as jnp

    return float(
        _stats.safe_auc_masked(
            jnp.asarray(np.asarray(amp, float), jnp.float32),
            jnp.asarray(np.asarray(time, float), jnp.float32),
        )
    )


def exp_decay_regression(time, amp) -> dict:
    """ln(amp)-vs-time regression → {'slope', 'r'} (linregress fields)."""
    import jax.numpy as jnp

    t = jnp.asarray(np.asarray(time, float), jnp.float32)
    a = jnp.asarray(np.asarray(amp, float), jnp.float32)
    m = jnp.ones(t.shape, bool)
    slope, r = _stats.exp_decay_regression_masked(t, a, m)
    return {"slope": float(slope), "r": float(r)}


def smooth_ma_nan(x, fs: float, sec: float):
    """NaN-tolerant moving average (optical_PC1.py:55-76)."""
    import jax.numpy as jnp

    x = np.asarray(x, float)
    if sec <= 0:
        return x.copy()
    k = smooth_window_len(fs, sec)
    return np.asarray(
        _peaks.smooth_ma_nan_dyn(jnp.asarray(x, jnp.float32), k, len(x)), dtype=float
    )


def rolling_p95_positive(pc1_s, fs: float, win_sec: float):
    """Rolling positive 95th percentile (optical_PC1.py:79-118)."""
    import jax.numpy as jnp

    x = np.asarray(pc1_s, float)
    win_n = max(3, ensure_odd(int(round(win_sec * fs))))
    return np.asarray(
        _peaks.rolling_p95_positive(jnp.asarray(x, jnp.float32), win_n, len(x)),
        dtype=float,
    )


def detect_cycles_positive_peaks(
    pc1, time_sec, fs, smooth_sec=0.20, p95_win_sec=2.0,
    peak_min_frac=0.20, peak_min_abs=0.0, min_dist_sec=0.2,
):
    """Cycle/peak detection (optical_PC1.py:121-228) on the JAX ops."""
    import jax.numpy as jnp

    pc1 = np.asarray(pc1, float)
    t = np.asarray(time_sec, float)
    k = smooth_window_len(fs, smooth_sec)
    p95w = max(3, ensure_odd(int(round(p95_win_sec * fs))))
    res = _peaks.detect_cycles_positive_peaks(
        jnp.asarray(pc1, jnp.float32), jnp.asarray(t, jnp.float32), k, p95w, len(pc1),
        peak_min_frac=peak_min_frac, peak_min_abs=peak_min_abs, min_dist_sec=min_dist_sec,
    )
    n_p = int(res.n_peaks)
    n_i = int(res.n_intervals)
    return (
        np.asarray(res.pc1_s, float),
        np.asarray(res.t_peaks, float)[:n_p],
        np.asarray(res.tm, float)[:n_i],
        np.asarray(res.T, float)[:n_i],
    )


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    in_csv = argv[0] if len(argv) > 0 else IN_CSV
    out_csv = argv[1] if len(argv) > 1 else OUT_CSV

    cols = contracts.read_pc1_csv(in_csv, PC1_COL)
    t = cols["t_sec"]
    pc1 = cols[PC1_COL]

    params = MetricParams(
        window_sec=WINDOW_SEC, smooth_sec=SMOOTH_SEC, peak_min_frac=PEAK_MIN_FRAC,
        peak_min_abs=PEAK_MIN_ABS, min_dist_sec=MIN_DIST_SEC,
    )
    mets = pc1_metrics(t, pc1, params, strict=True)
    contracts.write_csv(out_csv, contracts.summary_columns(mets, WINDOW_SEC, PC1_COL))


if __name__ == "__main__":
    main()
