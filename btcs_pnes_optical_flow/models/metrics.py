"""PC1 metric head: AUC, amplitude-decay slope, Kendall τ.

Behavioral clone of the reference's metric script body
(optical_PC1.py:234-299) including the three functions it calls but
never defines (SURVEY.md §2.4).  The jittable core operates on
fixed-capacity arrays with live masks; sample counts, the 0-10 s
window, and compaction all happen on device.

The smoothing window lengths depend on the estimated sampling rate
(a data-dependent scalar), which must be static under jit — so the
stage runs in two phases: a tiny jitted program estimates fs, the host
rounds it into window lengths, and the (cached per-window-shape) main
program computes the metrics.  For constant-rate cohorts every video
shares one compilation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from btcs_pnes_optical_flow.config import MetricParams
from btcs_pnes_optical_flow.ops import peaks, stats
from btcs_pnes_optical_flow.ops.filters import smooth_window_len


class PC1Metrics(NamedTuple):
    pc1_area: jnp.ndarray      # AUC of smoothed |PC1| over 0-10 s
    ads_slope: jnp.ndarray     # ln-amplitude decay slope
    ads_r2: jnp.ndarray
    kendall_tau: jnp.ndarray
    kendall_p: jnp.ndarray
    peak_n: jnp.ndarray        # int32
    status: jnp.ndarray        # 0 ok; 1 too few valid; 2 too few in window


def _compact_window(t_all, pc1_all, window_sec, min_valid):
    """Finite-pair compaction + 0-window_sec re-zeroed window.

    Mirrors optical_PC1.py:244-261: keep finite (t, pc1) pairs, re-zero
    time at the first kept sample, keep 0 <= t <= window_sec, compact.
    Returns (time, pc1, live_mask, count, status).
    """
    n = t_all.shape[0]
    fin = jnp.isfinite(t_all) & jnp.isfinite(pc1_all)
    o1 = jnp.nonzero(fin, size=n, fill_value=0)[0]
    c1 = jnp.sum(fin.astype(jnp.int32))
    slot = jnp.arange(n)
    t_c = jnp.where(slot < c1, t_all[o1], jnp.nan)
    p_c = jnp.where(slot < c1, pc1_all[o1], jnp.nan)

    t0 = t_c[0]
    time = t_c - t0
    in_win = (slot < c1) & (time >= 0.0) & (time <= window_sec)
    o2 = jnp.nonzero(in_win, size=n, fill_value=0)[0]
    c2 = jnp.sum(in_win.astype(jnp.int32))
    time2 = jnp.where(slot < c2, time[o2], jnp.nan)
    pc12 = jnp.where(slot < c2, p_c[o2], jnp.nan)

    status = jnp.where(c1 < min_valid, 1, jnp.where(c2 < min_valid, 2, 0))
    return time2, pc12, slot < c2, c2, status


@functools.partial(jax.jit, static_argnames=("params",))
def estimate_fs(t_all: jnp.ndarray, pc1_all: jnp.ndarray, params: MetricParams = MetricParams()):
    """Phase 1: sampling rate of the compacted 0-10 s window."""
    time, _, live, _, status = _compact_window(
        t_all, pc1_all, params.window_sec, params.min_valid_samples
    )
    return stats.estimate_fs_masked(time, live), status


@functools.partial(jax.jit, static_argnames=("k_smooth", "p95_win_n", "params"))
def pc1_metrics_core(
    t_all: jnp.ndarray,
    pc1_all: jnp.ndarray,
    k_smooth: int,
    p95_win_n: int,
    params: MetricParams = MetricParams(),
) -> PC1Metrics:
    """Phase 2: the three metrics, fully on device.

    ``k_smooth`` / ``p95_win_n`` are the fs-derived static window
    lengths (odd).  Matches optical_PC1.py:263-299.
    """
    time, pc1, live, count, status = _compact_window(
        t_all, pc1_all, params.window_sec, params.min_valid_samples
    )
    bad = status != 0

    # Metric 1: AUC of the 0.2-s smoothed |PC1|.
    amp = peaks.smooth_ma_nan_dyn(jnp.where(live, jnp.abs(pc1), jnp.nan), k_smooth, count)
    amp = jnp.where(live, amp, jnp.nan)
    area = stats.safe_auc_masked(amp, time)

    # Metric 2: amplitude decay slope (ln amp vs t).
    ads_slope, ads_r = stats.exp_decay_regression_masked(time, amp, live)
    ads_r2 = jnp.where(jnp.isfinite(ads_r), ads_r * ads_r, jnp.nan)

    # Metric 3: Kendall τ of inter-peak intervals.
    res = peaks.detect_cycles_positive_peaks(
        pc1,
        time,
        k_smooth,
        p95_win_n,
        count,
        peak_min_frac=params.peak_min_frac,
        peak_min_abs=params.peak_min_abs,
        min_dist_sec=params.min_dist_sec,
    )
    iv_live = jnp.arange(res.tm.shape[0]) < res.n_intervals
    tau, p = stats.kendalltau_masked(res.tm, res.T, iv_live)
    enough = res.n_intervals >= params.min_intervals_for_tau
    tau = jnp.where(enough, tau, jnp.nan)
    p = jnp.where(enough, p, jnp.nan)

    nanv = jnp.asarray(jnp.nan, pc1.dtype)
    return PC1Metrics(
        pc1_area=jnp.where(bad, nanv, area),
        ads_slope=jnp.where(bad, nanv, ads_slope),
        ads_r2=jnp.where(bad, nanv, ads_r2),
        kendall_tau=jnp.where(bad, nanv, tau),
        kendall_p=jnp.where(bad, nanv, p),
        peak_n=jnp.where(bad, 0, res.n_peaks),
        status=status,
    )


@functools.partial(jax.jit, static_argnames=("params",))
def _estimate_fs_batch(t_all, pc1_all, params: MetricParams = MetricParams()):
    return jax.vmap(lambda t, p: estimate_fs(t, p, params))(t_all, pc1_all)


@functools.partial(jax.jit, static_argnames=("k_smooth", "p95_win_n", "params"))
def _pc1_metrics_core_batch(t_all, pc1_all, k_smooth, p95_win_n,
                            params: MetricParams = MetricParams()):
    return jax.vmap(
        lambda t, p: pc1_metrics_core(t, p, k_smooth, p95_win_n, params)
    )(t_all, pc1_all)


def pc1_metrics_batch(
    t_all: np.ndarray,
    pc1_all: np.ndarray,
    params: MetricParams = MetricParams(),
) -> PC1Metrics:
    """Batched metric head: (K, N) waveforms → PC1Metrics of (K,) arrays.

    Semantically identical to K calls of :func:`pc1_metrics` (the
    reference loop over videos/ROIs, optical_PC1.py:234-299), but the
    fs estimate runs as ONE vmapped program for all K rows and the main
    metrics program runs once per distinct fs-derived window shape
    (constant-rate cohorts share one compilation) — two device round
    trips total instead of ~10 per row.

    Rows may be NaN-padded to a common capacity N; padding is ignored
    by the compaction step exactly like trailing invalid samples.
    """
    t_all = np.asarray(t_all, np.float32)
    pc1_all = np.asarray(pc1_all, np.float32)
    k = t_all.shape[0]
    fs_b, status_b = _estimate_fs_batch(jnp.asarray(t_all), jnp.asarray(pc1_all), params)
    fs_b = np.asarray(fs_b)
    status_b = np.asarray(status_b)

    out = {f: np.full((k,), np.nan, np.float64) for f in
           ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p")}
    peak_n = np.zeros((k,), np.int64)
    status = status_b.astype(np.int64).copy()

    # Group live rows by their static window lengths (one compile +
    # one dispatch per distinct sampling rate — usually exactly one).
    groups: dict = {}
    for i in range(k):
        if status_b[i] != 0:
            continue
        fs_f = float(fs_b[i])
        key = (
            smooth_window_len(fs_f, params.smooth_sec),
            max(3, smooth_window_len(fs_f, params.p95_win_sec)),
        )
        groups.setdefault(key, []).append(i)
    for (k_smooth, p95_win_n), idx in groups.items():
        sel = np.asarray(idx)
        res = _pc1_metrics_core_batch(
            jnp.asarray(t_all[sel]), jnp.asarray(pc1_all[sel]),
            k_smooth, p95_win_n, params,
        )
        res = jax.tree.map(np.asarray, res)
        for f in out:
            out[f][sel] = getattr(res, f)
        peak_n[sel] = res.peak_n
        status[sel] = res.status
    return PC1Metrics(
        pc1_area=out["pc1_area"], ads_slope=out["ads_slope"], ads_r2=out["ads_r2"],
        kendall_tau=out["kendall_tau"], kendall_p=out["kendall_p"],
        peak_n=peak_n, status=status,
    )


def pc1_metrics(t_all, pc1_all, params: MetricParams = MetricParams(), strict: bool = False):
    """Host-level metric extraction (two-phase fs handling).

    With ``strict=True`` raises RuntimeError on too-few samples exactly
    like the reference (optical_PC1.py:250,261); otherwise returns a
    NaN-filled result with a nonzero status.
    """
    t_all = jnp.asarray(t_all, jnp.float32)
    pc1_all = jnp.asarray(pc1_all, jnp.float32)
    fs, status = estimate_fs(t_all, pc1_all, params)
    st = int(status)
    if st != 0:
        if strict:
            msg = (
                "Too few valid samples in input CSV."
                if st == 1
                else "Too few samples in the 0-10 s window."
            )
            raise RuntimeError(msg)
        nan = float("nan")
        return PC1Metrics(*(jnp.asarray(v) for v in (nan, nan, nan, nan, nan, 0, st)))
    fs_f = float(fs)
    k_smooth = smooth_window_len(fs_f, params.smooth_sec)
    p95_win_n = max(3, smooth_window_len(fs_f, params.p95_win_sec))
    return pc1_metrics_core(t_all, pc1_all, k_smooth, p95_win_n, params)
