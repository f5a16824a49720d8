"""Jittable IIR filtering and smoothing ops.

Replacements for the SciPy C internals the reference calls:

- ``sosfilt`` / ``sosfiltfilt``  ↔ scipy.signal.sosfilt / sosfiltfilt
  (optical_PCA.py:119).  Two engines: a sequential ``lax.scan`` (exact
  rounding-order match to the C loop) and a parallel
  ``lax.associative_scan`` over affine state maps (log-depth, the
  parallel form — a biquad step is an affine map on its 2-state,
  so the prefix states are an associative scan of 2×2 affine maps).
- ``bandpass_nanrobust``  ↔ the reference's per-finite-run zero-phase
  filtering (optical_PCA.py:96-121), re-expressed with static shapes:
  runs are located with size-bounded ``nonzero`` and each run is
  filtered in a fixed-length staging buffer via gathers, so the whole
  thing jits and vmaps over batched signals.
- ``uniform_filter1d_nearest`` / ``smooth_ma_nan``  ↔
  scipy.ndimage.uniform_filter1d(mode="nearest") and the NaN-tolerant
  moving average built on it (optical_PC1.py:55-76).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from btcs_pnes_optical_flow.ops import design


# ---------------------------------------------------------------------------
# sosfilt
# ---------------------------------------------------------------------------


def _section_scan(b0, b1, b2, a1, a2, x, zi):
    """One biquad section, transposed direct-form II, sequential scan."""

    def step(carry, xn):
        z1, z2 = carry
        y = b0 * xn + z1
        z1n = b1 * xn - a1 * y + z2
        z2n = b2 * xn - a2 * y
        return (z1n, z2n), y

    (z1, z2), y = jax.lax.scan(step, (zi[0], zi[1]), x)
    return y, jnp.stack([z1, z2])


def _section_assoc(b0, b1, b2, a1, a2, x, zi):
    """One biquad section via associative scan in pole coordinates.

    The biquad state s_n = [z1, z2] obeys s_{n+1} = M s_n + c_n with
    M = [[-a1, 1], [-a2, 0]], whose eigenvalues are the section poles
    p, p̄.  Scanning affine 2×2 maps directly is numerically unstable in
    fp32 for poles near the unit circle (the products of the non-normal
    M transiently grow), so we diagonalize: with the left eigenvector
    w = [p, 1], the scalar mode d_n = p·z1_n + z2_n obeys
    d_{n+1} = p·d_n + γ·x_n — a perfectly-conditioned complex *scalar*
    linear recurrence, evaluated as an O(log N)-depth associative scan.
    The state is recovered as z1 = 2·Re(d/κ), z2 = 2·Re(d·v2/κ) with
    κ = (p² − a2)/p and right-eigenvector component v2 = −a2/p.

    Coefficients must be static Python floats; requires complex poles
    (a1² < 4·a2) — callers fall back to the sequential scan otherwise.
    """
    b0 = float(b0)
    b1 = float(b1)
    b2 = float(b2)
    a1 = float(a1)
    a2 = float(a2)
    disc = a1 * a1 - 4.0 * a2
    if disc >= 0.0:
        return _section_scan(b0, b1, b2, a1, a2, x, zi)
    p = complex(-a1 / 2.0, np.sqrt(-disc) / 2.0)
    gamma = (b1 - a1 * b0) * p + (b2 - a2 * b0)
    kappa = (p * p - a2) / p
    inv_kappa = 1.0 / kappa
    v2_over_kappa = (-a2 / p) * inv_kappa

    dt = x.dtype
    n = x.shape[0]
    # d_0 = p*z1_0 + z2_0  (complex, split into re/im lanes).
    d0_re = p.real * zi[0] + zi[1]
    d0_im = p.imag * zi[0]
    # u_n = gamma * x_n
    u_re = gamma.real * x
    u_im = gamma.imag * x

    pr = jnp.full((n,), p.real, dtype=dt)
    pi = jnp.full((n,), p.imag, dtype=dt)

    def combine(e1, e2):
        g1r, g1i, t1r, t1i = e1
        g2r, g2i, t2r, t2i = e2
        gr = g2r * g1r - g2i * g1i
        gi = g2r * g1i + g2i * g1r
        tr = g2r * t1r - g2i * t1i + t2r
        ti = g2r * t1i + g2i * t1r + t2i
        return gr, gi, tr, ti

    g_re, g_im, t_re, t_im = jax.lax.associative_scan(
        combine, (pr, pi, u_re, u_im), axis=0
    )
    # d_{n+1} = g_cum[n] * d_0 + t_cum[n]
    dn_re = g_re * d0_re - g_im * d0_im + t_re
    dn_im = g_re * d0_im + g_im * d0_re + t_im
    d_re = jnp.concatenate([jnp.reshape(d0_re, (1,)).astype(dt), dn_re[:-1]])
    d_im = jnp.concatenate([jnp.reshape(d0_im, (1,)).astype(dt), dn_im[:-1]])

    z1 = 2.0 * (d_re * inv_kappa.real - d_im * inv_kappa.imag)
    y = b0 * x + z1
    z1f = 2.0 * (dn_re[-1] * inv_kappa.real - dn_im[-1] * inv_kappa.imag)
    z2f = 2.0 * (dn_re[-1] * v2_over_kappa.real - dn_im[-1] * v2_over_kappa.imag)
    return y, jnp.stack([z1f, z2f])


def sosfilt(
    sos: jnp.ndarray, x: jnp.ndarray, zi: jnp.ndarray, engine: str = "assoc"
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cascade of second-order sections over a 1-D signal.

    Parameters
    ----------
    sos : (S, 6) coefficients, host-side numpy (static — they specialize
        the compiled program; a0 == 1 assumed, as produced by design).
    x : (N,) signal (traced).
    zi : (S, 2) per-section initial conditions (traced).
    engine : "scan" (sequential, bit-faithful order) or "assoc"
        (parallel log-depth in pole coordinates).

    Returns (y, zf).
    """
    sos = np.asarray(sos, dtype=np.float64)  # static host-side coefficients
    n_sections = sos.shape[0]
    fn = _section_assoc if engine == "assoc" else _section_scan
    v = x
    zf = []
    for s in range(n_sections):
        b0, b1, b2 = float(sos[s, 0]), float(sos[s, 1]), float(sos[s, 2])
        a1, a2 = float(sos[s, 4]), float(sos[s, 5])
        v, z = fn(b0, b1, b2, a1, a2, v, zi[s])
        zf.append(z)
    return v, jnp.stack(zf)


# ---------------------------------------------------------------------------
# sosfiltfilt (static-length, fully finite signal)
# ---------------------------------------------------------------------------


def odd_ext(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Odd extension at both ends (scipy.signal._arraytools.odd_ext)."""
    left = 2 * x[0] - x[n:0:-1]
    right = 2 * x[-1] - x[-2 : -(n + 2) : -1]
    return jnp.concatenate([left, x, right])


def sosfiltfilt(
    sos: jnp.ndarray,
    x: jnp.ndarray,
    zi: jnp.ndarray,
    padlen: int,
    engine: str = "assoc",
) -> jnp.ndarray:
    """Zero-phase forward-backward SOS filtering, odd padding.

    Reproduces scipy.signal.sosfiltfilt(sos, x, padlen=padlen): odd
    extension, forward pass seeded with zi*x_ext[0], backward pass
    seeded with zi*y[-1], trim.  ``padlen`` is static.
    """
    ext = odd_ext(x, padlen) if padlen > 0 else x
    y, _ = sosfilt(sos, ext, zi * ext[0], engine=engine)
    y_rev = y[::-1]
    y2, _ = sosfilt(sos, y_rev, zi * y_rev[0], engine=engine)
    y2 = y2[::-1]
    if padlen > 0:
        y2 = y2[padlen:-padlen]
    return y2


# ---------------------------------------------------------------------------
# NaN-robust band-pass over contiguous finite runs (masked, static shapes)
# ---------------------------------------------------------------------------


def finite_runs_bounded(mask: jnp.ndarray, max_runs: int):
    """Contiguous True runs as (starts, ends, n_runs), statically bounded.

    Mirrors the reference's ``finite_runs`` (optical_PCA.py:83-93) but in
    fixed shapes: returns ``max_runs`` slots; unused slots hold
    start = n (past the end) and end = -1.
    """
    n = mask.shape[0]
    prev = jnp.concatenate([jnp.array([False]), mask[:-1]])
    nxt = jnp.concatenate([mask[1:], jnp.array([False])])
    run_start = mask & ~prev
    run_end = mask & ~nxt
    starts = jnp.nonzero(run_start, size=max_runs, fill_value=n)[0]
    ends = jnp.nonzero(run_end, size=max_runs, fill_value=-1)[0]
    n_runs = jnp.sum(run_start.astype(jnp.int32))
    return starts, ends, n_runs


def _filtfilt_one_run(
    sos: jnp.ndarray,
    zi: jnp.ndarray,
    x: jnp.ndarray,
    start: jnp.ndarray,
    end: jnp.ndarray,
    padreq: int,
    engine: str,
) -> jnp.ndarray:
    """filtfilt one finite run [start, end] of x inside a fixed buffer.

    The run (dynamic offset/length) is gathered into a staging buffer of
    static length N + 2*padreq laid out as
    [left odd ext (pad) | segment (size) | right odd ext (pad) | fill],
    filtered forward and (window-reversed) backward, and the de-padded
    result is returned aligned to the original x positions (garbage
    outside the run — caller masks).
    """
    n = x.shape[0]
    pmax = padreq
    ell = n + 2 * pmax
    size = end - start + 1
    pad = jnp.minimum(pmax, size // 2 - 1)
    pad = jnp.maximum(pad, 0)

    def seg(i):
        # x[start + clip(i)] with i clipped into the run; always finite.
        return x[jnp.clip(start + jnp.clip(i, 0, size - 1), 0, n - 1)]

    j = jnp.arange(ell)
    first = seg(jnp.zeros_like(j))
    last = seg(jnp.full_like(j, size - 1))
    # Window layout: ext[j] for j in [0, 2*pad + size).
    left_val = 2.0 * first - seg(pad - j)  # j in [0, pad)
    mid_val = seg(j - pad)  # j in [pad, pad+size)
    right_val = 2.0 * last - seg(2 * size + pad - 2 - j)  # j in [pad+size, 2pad+size)
    ext = jnp.where(j < pad, left_val, jnp.where(j < pad + size, mid_val, right_val))
    # Past the window: replicate a finite value so the filter state
    # stays finite (output there is discarded).
    wlen = 2 * pad + size
    ext = jnp.where(j < wlen, ext, last)

    yf, _ = sosfilt(sos, ext, zi * ext[0], engine=engine)
    # Reverse within the (dynamic) window, filter again, reverse back.
    rev_idx = jnp.clip(wlen - 1 - j, 0, ell - 1)
    yr = yf[rev_idx]
    yr = jnp.where(j < wlen, yr, yr[0])
    yb, _ = sosfilt(sos, yr, zi * yr[0], engine=engine)
    # Final value for run-local index i (0-based): reverse(yb)[pad + i]
    # = yb[wlen - 1 - (pad + i)] = yb[pad + size - 1 - i].
    i_local = jnp.arange(n) - start
    out_idx = jnp.clip(pad + size - 1 - i_local, 0, ell - 1)
    y_run = yb[out_idx]
    # pad <= 0 edge case (reference keeps the raw segment).
    passthrough = x[jnp.clip(jnp.arange(n), start, end)]
    return jnp.where(pad > 0, y_run, passthrough)


def bandpass_nanrobust(
    x: jnp.ndarray,
    sos: jnp.ndarray,
    zi: jnp.ndarray,
    padreq: int,
    max_runs: int = 64,
    engine: str = "assoc",
) -> jnp.ndarray:
    """Zero-phase band-pass, applied per contiguous finite run.

    Behavioral contract (optical_PCA.py:96-121): runs shorter than
    ``padreq + 1`` stay NaN; pad is clamped to ``size//2 - 1``; output
    is NaN outside finite runs.
    """
    n = x.shape[0]
    xf = jnp.where(jnp.isfinite(x), x, 0.0)
    mask = jnp.isfinite(x)
    starts, ends, n_runs = finite_runs_bounded(mask, max_runs)
    minlen = padreq + 1

    def one(start, end):
        return _filtfilt_one_run(sos, zi, xf, start, end, padreq, engine)

    ys = jax.vmap(one)(starts, ends)  # (max_runs, N)

    idx = jnp.arange(n)[None, :]
    sizes = (ends - starts + 1)[:, None]
    run_ok = (jnp.arange(max_runs)[:, None] < n_runs) & (sizes >= minlen)
    in_run = (idx >= starts[:, None]) & (idx <= ends[:, None]) & run_ok
    y = jnp.full((n,), jnp.nan, dtype=x.dtype)
    # Runs are disjoint, so a masked sum-select is exact.
    y = jnp.where(jnp.any(in_run, axis=0), jnp.sum(jnp.where(in_run, ys, 0.0), axis=0), y)
    return y


def make_bandpass(
    low_hz: float,
    high_hz: float,
    fs: float,
    order: int = 4,
    dtype=np.float32,
):
    """Design a band-pass; returns host-side (sos, zi, padreq) constants."""
    sos_np = design.butter_bandpass_sos(low_hz, high_hz, fs, order)
    zi_np = design.sosfilt_zi(sos_np).astype(dtype)
    padreq = design.sos_required_padlen(sos_np)
    return sos_np, zi_np, padreq


# ---------------------------------------------------------------------------
# Moving averages (scipy.ndimage.uniform_filter1d semantics)
# ---------------------------------------------------------------------------


def uniform_filter1d_nearest(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Centered box mean, edge-replicated (mode="nearest"), origin 0.

    Window for index i covers offsets [-(size//2), size - size//2 - 1].
    Implemented as edge-pad + windowed tree reduction (better fp32
    accumulation than a cumsum difference).
    """
    left = size // 2
    right = size - left - 1
    xp = jnp.pad(x, (left, right), mode="edge")
    win = jax.lax.reduce_window(
        xp, 0.0, jax.lax.add, (size,), (1,), "VALID"
    )
    return win / size


def smooth_ma_nan(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """NaN-tolerant moving average (optical_PC1.py:55-76).

    ``k`` is the (odd) static window length; the reference computes it
    as ``ensure_odd(max(1, round(fs * sec)))``.
    """
    valid = jnp.isfinite(x)
    x2 = jnp.where(valid, x, 0.0)
    num = uniform_filter1d_nearest(x2, k)
    den = uniform_filter1d_nearest(valid.astype(x.dtype), k)
    y = num / jnp.maximum(den, 1e-12)
    return jnp.where(den < 1e-12, jnp.nan, y)


def ensure_odd(n: int) -> int:
    """int(n) | 1 (optical_PC1.py:47-52)."""
    return int(n) | 1


def smooth_window_len(fs: float, sec: float) -> int:
    """Window length used by the reference's smoother: odd(max(1, round(fs*sec)))."""
    import math

    r = fs * sec
    f = math.floor(r)
    d = r - f
    if d > 0.5:
        ri = f + 1
    elif d < 0.5:
        ri = f
    else:
        ri = f + 1 if f % 2 else f
    return ensure_odd(max(1, ri))
