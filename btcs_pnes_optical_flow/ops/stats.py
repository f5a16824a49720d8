"""Rank statistics and regressions (vectorized, masked static shapes).

Replaces the SciPy statistics the metric stage calls
(SURVEY.md §2.3 N10-N11 and §2.4):

- ``kendalltau_masked``  ↔ scipy.stats.kendalltau (τ-b, tie-corrected,
  with both the exact small-n p-value — Kendall's inversion-count
  distribution as a bounded DP — and the tie-corrected asymptotic
  normal approximation, selected by scipy's 'auto' rule).
- ``linregress_masked``  ↔ scipy.stats.linregress (slope/intercept/r).
- ``safe_auc_masked``    — NaN-robust trapezoid (the undefined
  ``safe_auc`` the reference calls at optical_PC1.py:267).
- ``estimate_fs_masked`` — 1/median(Δt) (undefined
  ``estimate_fs_from_time``, optical_PC1.py:263).
- ``exp_decay_regression_masked`` — ln-amplitude decay slope
  (undefined ``exp_decay_regression``, optical_PC1.py:270).

All functions take a validity mask and a static capacity; invalid slots
are ignored exactly as if the arrays had been compacted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# scipy's 'auto' rule switches to the exact distribution when there are
# no ties and (n <= 33 or min(dis, tot-dis) <= 1).
_EXACT_N_MAX = 33
_EXACT_C_MAX = (_EXACT_N_MAX * (_EXACT_N_MAX - 1)) // 4 + 1  # 265


def masked_median(x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Median over valid entries (numpy semantics: mean of middles)."""
    big = jnp.asarray(jnp.inf, x.dtype)
    xs = jnp.sort(jnp.where(valid, x, big))
    c = jnp.sum(valid.astype(jnp.int32))
    lo = xs[jnp.maximum((c - 1) // 2, 0)]
    hi = xs[jnp.maximum(c // 2, 0)]
    med = 0.5 * (lo + hi)
    return jnp.where(c > 0, med, jnp.nan)


def estimate_fs_masked(time: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Sampling rate of a compacted time vector: 1 / median(diff).

    ``m`` marks the live prefix (compaction mask); diffs between
    consecutive live samples only.
    """
    d = time[1:] - time[:-1]
    dv = m[1:] & m[:-1]
    return 1.0 / masked_median(d, dv)


def safe_auc_masked(amp: jnp.ndarray, time: jnp.ndarray) -> jnp.ndarray:
    """NaN-robust trapezoidal integral of amp(t).

    Integrates over consecutive finite pairs only (equivalent to
    per-finite-run trapezoids, gaps contribute nothing); NaN when fewer
    than 2 finite samples exist.
    """
    fin = jnp.isfinite(amp) & jnp.isfinite(time)
    pair = fin[1:] & fin[:-1]
    a0 = jnp.where(fin[:-1], amp[:-1], 0.0)
    a1 = jnp.where(fin[1:], amp[1:], 0.0)
    dt = jnp.where(pair, time[1:] - time[:-1], 0.0)
    total = jnp.sum(jnp.where(pair, 0.5 * (a0 + a1) * dt, 0.0))
    return jnp.where(jnp.sum(fin.astype(jnp.int32)) >= 2, total, jnp.nan)


def linregress_masked(x: jnp.ndarray, y: jnp.ndarray, m: jnp.ndarray):
    """OLS slope and correlation over masked samples (scipy.linregress).

    Returns (slope, intercept, r).  Degenerate cases follow scipy:
    r = 0 when either variance vanishes; NaN slope when x-variance is 0
    or fewer than 2 samples.
    """
    mf = m.astype(x.dtype)
    n = jnp.sum(mf)
    nsafe = jnp.maximum(n, 1.0)
    xm = jnp.sum(jnp.where(m, x, 0.0)) / nsafe
    ym = jnp.sum(jnp.where(m, y, 0.0)) / nsafe
    dx = jnp.where(m, x - xm, 0.0)
    dy = jnp.where(m, y - ym, 0.0)
    ssxm = jnp.sum(dx * dx)
    ssym = jnp.sum(dy * dy)
    ssxym = jnp.sum(dx * dy)
    slope = jnp.where(ssxm > 0, ssxym / jnp.maximum(ssxm, 1e-30), jnp.nan)
    intercept = ym - slope * xm
    denom = jnp.sqrt(jnp.maximum(ssxm * ssym, 1e-30))
    r = jnp.where((ssxm > 0) & (ssym > 0), ssxym / denom, 0.0)
    r = jnp.clip(r, -1.0, 1.0)
    bad = n < 2
    return (
        jnp.where(bad, jnp.nan, slope),
        jnp.where(bad, jnp.nan, intercept),
        jnp.where(bad, jnp.nan, r),
    )


def exp_decay_regression_masked(time: jnp.ndarray, amp: jnp.ndarray, m: jnp.ndarray):
    """Amplitude-decay-slope regression: ln(amp) vs time.

    Spec for the reference's undefined ``exp_decay_regression``
    (SURVEY.md §2.4): restrict to finite amp > 0, regress ln(amp) on
    time; returns (slope, r), NaN when < 2 valid points.
    """
    ok = m & jnp.isfinite(amp) & (amp > 0) & jnp.isfinite(time)
    la = jnp.log(jnp.where(ok, amp, 1.0))
    slope, _, r = linregress_masked(time, la, ok)
    n = jnp.sum(ok.astype(jnp.int32))
    bad = n < 2
    return jnp.where(bad, jnp.nan, slope), jnp.where(bad, jnp.nan, r)


# ---------------------------------------------------------------------------
# Kendall τ-b
# ---------------------------------------------------------------------------


def _kendall_p_exact_two_sided(n: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Exact two-sided p-value of Kendall's statistic, bounded DP.

    Kendall's null distribution of the discordant-pair count is the
    inversion-number distribution of random permutations; the CDF is
    built by the classic generating-function recurrence
    f_j = windowed-cumsum(f_{j-1}) (Kendall 1970), exactly as scipy's
    ``_kendall_p_exact`` does for n < 171.  ``c`` must already be the
    min(dis, tot-dis) fold.  Static bounds: n <= 33, c <= 264.
    """
    kmax = _EXACT_C_MAX
    idx = jnp.arange(kmax)
    new = jnp.where(idx < 2, 1.0, 0.0).astype(jnp.float32)
    cm = jnp.minimum(c, kmax - 1)

    def body(j, acc):
        g = jnp.cumsum(acc)
        sh = jnp.where(idx - j >= 0, g[jnp.maximum(idx - j, 0)], 0.0)
        upd = g - jnp.where((idx >= j) & (j <= cm), sh, 0.0)
        return jnp.where(j <= n, upd, acc)

    new = jax.lax.fori_loop(3, _EXACT_N_MAX + 1, body, new)
    total = jnp.sum(jnp.where(idx <= cm, new, 0.0))
    log_nfact = jax.lax.lgamma(n.astype(jnp.float32) + 1.0)
    prob = 2.0 * total * jnp.exp(-log_nfact)
    # The DP only iterates to n = 33; scipy's 'auto' rule uses the exact
    # method for n > 33 only when c <= 1, which has a closed form:
    # count(k<=0) = 1, count(k<=1) = n.
    log_nm1fact = jax.lax.lgamma(n.astype(jnp.float32))
    prob_big = jnp.where(c <= 0, 2.0 * jnp.exp(-log_nfact), 2.0 * jnp.exp(-log_nm1fact))
    prob = jnp.where(n > _EXACT_N_MAX, prob_big, prob)
    # c exactly at the distribution midpoint → two-sided p = 1.
    prob = jnp.where(4 * c == n * (n - 1), 1.0, prob)
    return jnp.clip(prob, 0.0, 1.0)


def kendalltau_masked(x: jnp.ndarray, y: jnp.ndarray, m: jnp.ndarray):
    """Kendall τ-b and two-sided p-value over masked samples.

    Pairwise O(n²) formulation (n = valid count is tiny here — it is
    the number of inter-peak intervals): concordant-minus-discordant is
    Σ_{i<j} sgn(Δx)·sgn(Δy); tie corrections via per-element tied-group
    sizes.  Method selection and p-values follow scipy.stats.kendalltau
    (method='auto').  Returns (tau, p); (nan, nan) when degenerate.
    """
    dt = x.dtype
    n = jnp.sum(m.astype(jnp.int32))
    mm = (m[:, None] & m[None, :])
    iu = jnp.triu(jnp.ones(mm.shape, bool), k=1)
    pair = mm & iu
    dxs = jnp.sign(x[None, :] - x[:, None])
    dys = jnp.sign(y[None, :] - y[:, None])
    cmd = jnp.sum(jnp.where(pair, dxs * dys, 0.0))

    ex = (x[None, :] == x[:, None])
    ey = (y[None, :] == y[:, None])
    xtie = jnp.sum(jnp.where(pair & ex, 1.0, 0.0))
    ytie = jnp.sum(jnp.where(pair & ey, 1.0, 0.0))
    ntie = jnp.sum(jnp.where(pair & ex & ey, 1.0, 0.0))

    # Per-element tied-group sizes (for the higher-order tie moments).
    cx = jnp.sum(jnp.where(mm & ex, 1.0, 0.0), axis=1)  # group size per i
    cy = jnp.sum(jnp.where(mm & ey, 1.0, 0.0), axis=1)
    mv = m.astype(dt)
    x0 = jnp.sum(mv * (cx - 1.0) * (cx - 2.0))  # Σ t(t-1)(t-2)
    y0 = jnp.sum(mv * (cy - 1.0) * (cy - 2.0))
    x1 = jnp.sum(mv * (cx - 1.0) * (2.0 * cx + 5.0))  # Σ t(t-1)(2t+5)
    y1 = jnp.sum(mv * (cy - 1.0) * (2.0 * cy + 5.0))

    nf = n.astype(dt)
    tot = nf * (nf - 1.0) / 2.0
    dis = (tot - xtie - ytie + ntie - cmd) / 2.0

    denom = jnp.sqrt(jnp.maximum(tot - xtie, 1e-30)) * jnp.sqrt(
        jnp.maximum(tot - ytie, 1e-30)
    )
    tau = jnp.clip(cmd / denom, -1.0, 1.0)

    # p-value, scipy method='auto'.
    no_ties = (xtie == 0) & (ytie == 0)
    cfold = jnp.minimum(dis, tot - dis)
    use_exact = no_ties & ((n <= _EXACT_N_MAX) | (cfold <= 1.0))

    def p_exact(_):
        return _kendall_p_exact_two_sided(n, cfold.astype(jnp.int32))

    def p_asym(_):
        mfac = nf * (nf - 1.0)
        var = (
            (mfac * (2.0 * nf + 5.0) - x1 - y1) / 18.0
            + (2.0 * xtie * ytie) / jnp.maximum(mfac, 1.0)
            + x0 * y0 / jnp.maximum(9.0 * mfac * (nf - 2.0), 1.0)
        )
        z = cmd / jnp.sqrt(jnp.maximum(var, 1e-30))
        # two-sided normal p = erfc(|z|/sqrt(2))
        return jax.scipy.special.erfc(jnp.abs(z) / jnp.sqrt(jnp.asarray(2.0, dt)))

    p = jax.lax.cond(use_exact, p_exact, p_asym, operand=None)

    degenerate = (n < 2) | (xtie >= tot) | (ytie >= tot)
    tau = jnp.where(degenerate, jnp.nan, tau)
    p = jnp.where(degenerate, jnp.nan, p)
    return tau, p
