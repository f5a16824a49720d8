"""Cycle-based positive-peak detection (vectorized, masked shapes).

Behavioral clone of the reference's metric-stage peak machinery
(optical_PC1.py:79-228, SURVEY.md C20-C21), re-expressed without
data-dependent Python loops:

- ``rolling_p95_positive``: the reference's O(N·win) per-sample Python
  loop becomes one (N, win) gather + row sort + interpolated quantile.
- ``detect_cycles_positive_peaks``: zero-crossing cycle segmentation is
  vectorized with a reverse-cummin "next down-crossing" map and an
  O(N²) masked argmax per cycle (N here is the 10-s metric window, a
  few hundred samples — trivially small); the sequential
  0.2-s merge pass is a tiny lax.scan with constant state.

All arrays carry a live-prefix length ``m_count`` so the same compiled
program serves any actual sample count up to the static capacity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from btcs_pnes_optical_flow.ops.filters import smooth_window_len


def uniform_filter1d_nearest_dyn(x: jnp.ndarray, k: int, m_count) -> jnp.ndarray:
    """Centered box mean with edge replication over a dynamic prefix.

    Equivalent to scipy.ndimage.uniform_filter1d(x[:m_count], size=k,
    mode="nearest") evaluated into the first ``m_count`` slots; values
    past the prefix are garbage.
    """
    n = x.shape[0]
    half = k // 2
    offs = jnp.arange(-half, k - half)
    idx = jnp.arange(n)[:, None] + offs[None, :]
    idx = jnp.clip(idx, 0, jnp.maximum(m_count - 1, 0))
    return jnp.mean(x[idx], axis=1)


def smooth_ma_nan_dyn(x: jnp.ndarray, k: int, m_count) -> jnp.ndarray:
    """NaN-tolerant moving average over a dynamic prefix (C19)."""
    valid = jnp.isfinite(x)
    x2 = jnp.where(valid, x, 0.0)
    num = uniform_filter1d_nearest_dyn(x2, k, m_count)
    den = uniform_filter1d_nearest_dyn(valid.astype(x.dtype), k, m_count)
    y = num / jnp.maximum(den, 1e-12)
    return jnp.where(den < 1e-12, jnp.nan, y)


def rolling_p95_positive(pc1_s: jnp.ndarray, win_n: int, m_count) -> jnp.ndarray:
    """Rolling 95th percentile of positive finite values (C20).

    Centered window of static length ``win_n`` (odd, >= 3), truncated at
    the array edges exactly like the reference's max(0,·)/min(N,·)
    bounds; windows with < 5 valid values yield NaN.  Quantile uses
    numpy's linear interpolation on the sorted valid values.
    """
    n = pc1_s.shape[0]
    half = win_n // 2
    offs = jnp.arange(-half, half + 1)
    idx = jnp.arange(n)[:, None] + offs[None, :]
    inb = (idx >= 0) & (idx < m_count)
    vals = pc1_s[jnp.clip(idx, 0, n - 1)]
    ok = inb & jnp.isfinite(vals) & (vals > 0)
    big = jnp.asarray(jnp.inf, pc1_s.dtype)
    sorted_vals = jnp.sort(jnp.where(ok, vals, big), axis=1)
    v = jnp.sum(ok, axis=1)
    # np.percentile(seg, 95): pos = 0.95*(v-1); linear interpolation.
    pos = 0.95 * (v - 1).astype(pc1_s.dtype)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, jnp.maximum(v - 1, 0))
    frac = pos - lo.astype(pc1_s.dtype)
    lo = jnp.clip(lo, 0, win_n - 1)
    hi = jnp.clip(hi, 0, win_n - 1)
    row = jnp.arange(n)
    s_lo = sorted_vals[row, lo]
    s_hi = sorted_vals[row, hi]
    p95 = s_lo + frac * (s_hi - s_lo)
    return jnp.where(v >= 5, p95, jnp.nan)


class PeakResult(NamedTuple):
    pc1_s: jnp.ndarray     # (N,) smoothed PC1
    t_peaks: jnp.ndarray   # (N,) peak times, live prefix
    n_peaks: jnp.ndarray   # () int32
    tm: jnp.ndarray        # (N,) interval midpoints, live prefix
    T: jnp.ndarray         # (N,) inter-peak intervals, live prefix
    n_intervals: jnp.ndarray  # () int32


def detect_cycles_positive_peaks(
    pc1: jnp.ndarray,
    time_sec: jnp.ndarray,
    k_smooth: int,
    p95_win_n: int,
    m_count,
    peak_min_frac: float = 0.20,
    peak_min_abs: float = 0.0,
    min_dist_sec: float = 0.2,
) -> PeakResult:
    """Positive-peak detection over cycles (optical_PC1.py:121-228).

    ``k_smooth``/``p95_win_n`` are the static window lengths the
    reference derives from fs (`smooth_window_len(fs, 0.2)` and
    `max(3, round(fs*2.0)|1)`); ``m_count`` is the live prefix length.
    """
    n = pc1.shape[0]
    dt = pc1.dtype
    i_all = jnp.arange(n)
    live = i_all < m_count

    pc1_live = jnp.where(live, pc1, jnp.nan)
    pc1_s = smooth_ma_nan_dyn(pc1_live, k_smooth, m_count)
    pc1_s = jnp.where(live, pc1_s, jnp.nan)
    local_p95 = rolling_p95_positive(pc1_s, p95_win_n, m_count)

    # Zero crossings (NaN comparisons are False, so gaps yield none).
    y0 = pc1_s[:-1]
    y1 = pc1_s[1:]
    up = (y0 <= 0) & (y1 > 0)          # index i: crossing between i, i+1
    dn = (y0 > 0) & (y1 <= 0)

    # next down-crossing strictly after iu: reverse cumulative min of
    # dn indices.
    big_i = jnp.asarray(n + 1, jnp.int32)
    dn_idx = jnp.where(dn, i_all[:-1].astype(jnp.int32), big_i)
    nd_incl = jax.lax.cummin(dn_idx, axis=0, reverse=True)
    nd_after = jnp.concatenate([nd_incl[1:], jnp.full((1,), big_i)])  # > i
    has_dn = nd_after < big_i

    # Per-cycle masked argmax: A[i, j] = pc1_s[j] for j in [i, end_i].
    end = jnp.where(has_dn, nd_after + 1, 0).astype(jnp.int32)  # inclusive end
    j_col = i_all[None, :]
    i_row = i_all[:-1, None]
    in_seg = (j_col >= i_row) & (j_col <= end[:, None]) & up[:, None] & has_dn[:, None]
    vals = jnp.where(in_seg & jnp.isfinite(pc1_s)[None, :], pc1_s[None, :], -jnp.inf)
    seg_max = jnp.max(vals, axis=1)
    # First index achieving the max (nanargmax tie rule).
    hit = vals == seg_max[:, None]
    peak_idx = jnp.argmax(hit, axis=1).astype(jnp.int32)
    a_peak = seg_max
    cand_valid = up & has_dn & jnp.isfinite(a_peak) & (a_peak > -jnp.inf)

    # Local threshold at the peak index (optical_PC1.py:188-195).
    ref_v = local_p95[jnp.clip(peak_idx, 0, n - 1)]
    thr = jnp.full((n - 1,), peak_min_abs, dt)
    thr = jnp.where(
        jnp.isfinite(ref_v) & (ref_v > 0),
        jnp.maximum(thr, peak_min_frac * ref_v),
        thr,
    )
    cand_valid = cand_valid & (a_peak >= thr)
    t_cand = time_sec[jnp.clip(peak_idx, 0, n - 1)]

    # ---- Merge peaks closer than min_dist_sec (sequential greedy,
    # optical_PC1.py:207-218).  Scan over candidates in up-crossing
    # order; carry the current group's representative.
    def step(carry, inp):
        last_t, last_a, started = carry
        valid, t, a = inp
        is_new = valid & (~started | ((t - last_t) >= min_dist_sec))
        repl = valid & started & ((t - last_t) < min_dist_sec) & (a > last_a)
        new_t = jnp.where(is_new | repl, t, last_t)
        new_a = jnp.where(is_new, a, jnp.where(repl, a, last_a))
        new_started = started | valid
        return (new_t, new_a, new_started), (is_new, new_t, new_a)

    init = (jnp.asarray(0.0, dt), jnp.asarray(0.0, dt), jnp.asarray(False))
    _, (is_new, rep_t, rep_a) = jax.lax.scan(
        step, init, (cand_valid, t_cand.astype(dt), a_peak.astype(dt))
    )

    # Group finalization: each group's representative is the carried
    # value at the last slot before the next group starts (or the scan
    # end).  A slot ends a group iff a group has started by then and the
    # next slot begins a new one (or it is the final slot).
    nxt_new = jnp.concatenate([is_new[1:], jnp.zeros((1,), bool)])
    started_by = jax.lax.cummax(is_new.astype(jnp.int32), axis=0) > 0
    group_end = started_by & (nxt_new | (jnp.arange(n - 1) == n - 2))

    n_peaks = jnp.sum(is_new.astype(jnp.int32))
    order = jnp.nonzero(group_end, size=n - 1, fill_value=0)[0]
    slot_p = jnp.arange(n - 1)
    t_peaks = jnp.where(slot_p < n_peaks, rep_t[order], jnp.nan)

    # Intervals between consecutive kept peaks (optical_PC1.py:224-228).
    T = t_peaks[1:] - t_peaks[:-1]                  # (n-2,)
    tm = 0.5 * (t_peaks[1:] + t_peaks[:-1])
    slot = jnp.arange(n - 2)
    iv_valid = (slot + 1 < n_peaks) & (n_peaks >= 2)
    iv_valid = iv_valid & jnp.isfinite(T) & (T > 0)
    n_iv = jnp.sum(iv_valid.astype(jnp.int32))
    comp = jnp.nonzero(iv_valid, size=n - 2, fill_value=0)[0]
    T_c = jnp.where(slot < n_iv, T[comp], jnp.nan)
    tm_c = jnp.where(slot < n_iv, tm[comp], jnp.nan)

    pad1 = jnp.full((1,), jnp.nan, dt)
    pad2 = jnp.full((2,), jnp.nan, dt)
    return PeakResult(
        pc1_s=pc1_s,
        t_peaks=jnp.concatenate([t_peaks, pad1]),  # capacity n
        n_peaks=n_peaks,
        tm=jnp.concatenate([tm_c, pad2]),          # capacity n
        T=jnp.concatenate([T_c, pad2]),
        n_intervals=n_iv,
    )
