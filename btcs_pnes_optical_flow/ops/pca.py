"""Sliding-window dynamic PC1 (vectorized).

Replaces the reference's per-window Python loop over np.cov +
np.linalg.eigh (optical_PCA.py:136-235, SURVEY.md C14-C15) with a fully
vectorized formulation:

- every window is materialized as one gather → (K, win_n) batch;
- the 2×2 symmetric eigenproblem is solved in closed form;
- the reference's *sequential* two-stage sign stabilization (align to a
  reference axis, then flip against the previous accepted window) is an
  exact prefix product of ±1 factors over the accepted-window chain —
  a cumprod, not a scan;
- nearest-center axis assignment reproduces the reference's
  searchsorted-left + strictly-closer-earlier tie rule
  (optical_PCA.py:218-225: ties go to the *later* center).

Everything is static-shaped and jit/vmap-friendly; windows with fewer
than ``min_samples`` finite samples are masked out exactly as the
reference skips them.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def eigvec2x2_major(cxx: jnp.ndarray, cxy: jnp.ndarray, cyy: jnp.ndarray):
    """Unit eigenvector of the largest eigenvalue of [[cxx,cxy],[cxy,cyy]].

    Closed form; sign is arbitrary (resolved by the caller's alignment
    chain, mirroring np.linalg.eigh's arbitrary sign).  For the zero /
    isotropic matrix returns an axis vector ([1,0] if cxx >= cyy).
    """
    half_diff = 0.5 * (cxx - cyy)
    root = jnp.sqrt(half_diff * half_diff + cxy * cxy)
    lam = 0.5 * (cxx + cyy) + root
    # Two algebraically equivalent candidates; pick the better-conditioned.
    v1 = jnp.stack([cxy, lam - cxx], axis=-1)
    v2 = jnp.stack([lam - cyy, cxy], axis=-1)
    n1 = jnp.sum(v1 * v1, axis=-1)
    n2 = jnp.sum(v2 * v2, axis=-1)
    v = jnp.where((n1 >= n2)[..., None], v1, v2)
    nrm = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    axis = jnp.where(
        (cxx >= cyy)[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0], v.dtype), v.shape),
        jnp.broadcast_to(jnp.array([0.0, 1.0], v.dtype), v.shape),
    )
    tiny = jnp.asarray(1e-30, v.dtype)
    return jnp.where(nrm > tiny, v / jnp.maximum(nrm, tiny), axis)


def window_axes(
    vx: jnp.ndarray,
    vy: jnp.ndarray,
    win_n: int,
    step_n: int,
    min_samples: int = 3,
    ref=(0.0, 1.0),
):
    """Per-window principal axes with reference-exact sign stabilization.

    Returns (centers, w_aligned, valid) over the K static windows:
    centers (K,) int32 window-center sample indices, w_aligned (K, 2)
    sign-stabilized axes (meaningless where ~valid), valid (K,) bool.
    """
    n = vx.shape[0]
    starts = np.arange(0, n - win_n + 1, step_n, dtype=np.int32)
    k = starts.shape[0]
    centers = jnp.asarray((2 * starts + win_n - 1) // 2, jnp.int32)

    idx = jnp.asarray(starts)[:, None] + jnp.arange(win_n, dtype=jnp.int32)[None, :]
    wx = vx[idx]  # (K, win_n)
    wy = vy[idx]
    m = jnp.isfinite(wx) & jnp.isfinite(wy)
    cnt = jnp.sum(m, axis=1)
    valid = cnt >= min_samples
    cntf = jnp.maximum(cnt, 1).astype(vx.dtype)

    wx0 = jnp.where(m, wx, 0.0)
    wy0 = jnp.where(m, wy, 0.0)
    mx = jnp.sum(wx0, axis=1) / cntf
    my = jnp.sum(wy0, axis=1) / cntf
    dx = jnp.where(m, wx - mx[:, None], 0.0)
    dy = jnp.where(m, wy - my[:, None], 0.0)
    # np.cov with default ddof → N-1 normalization (optical_PCA.py:197).
    denom = jnp.maximum(cnt - 1, 1).astype(vx.dtype)
    cxx = jnp.sum(dx * dx, axis=1) / denom
    cxy = jnp.sum(dx * dy, axis=1) / denom
    cyy = jnp.sum(dy * dy, axis=1) / denom

    w = eigvec2x2_major(cxx, cxy, cyy)  # (K, 2)

    # Stage (a): align to the reference axis — flip iff dot(w, ref) < 0
    # (optical_PCA.py:127-133).
    refv = jnp.asarray(ref, w.dtype)
    # HIGHEST: this sign decides the flip, and a TF32 product can get
    # it wrong when w is nearly orthogonal to the reference axis.
    d_ref = jnp.matmul(w, refv, precision=jax.lax.Precision.HIGHEST)
    w = jnp.where((d_ref < 0)[:, None], -w, w)

    # Stage (b): temporal continuity along the *accepted* chain — the
    # sequential "flip if dot with previous accepted < 0" is the prefix
    # product of per-link sign factors (exact rewrite of
    # optical_PCA.py:203-205).
    acc_idx = jnp.nonzero(valid, size=k, fill_value=0)[0]  # (K,), compact
    a_count = jnp.sum(valid.astype(jnp.int32))
    w_acc = w[acc_idx]  # (K, 2); slots >= a_count are garbage
    link = jnp.sum(w_acc[1:] * w_acc[:-1], axis=1)
    factors = jnp.where(link < 0, -1.0, 1.0).astype(w.dtype)
    sigma = jnp.concatenate([jnp.ones((1,), w.dtype), jnp.cumprod(factors)])
    w_acc = sigma[:, None] * w_acc

    return centers, acc_idx, a_count, w_acc, valid


def dynamic_pc1_sliding(
    vx: jnp.ndarray,
    vy: jnp.ndarray,
    win_n: int,
    step_n: int,
    min_samples: int = 3,
    ref=(0.0, 1.0),
) -> jnp.ndarray:
    """Dynamic PC1 waveform — behavioral clone of optical_PCA.py:136-235.

    ``win_n``/``step_n`` are static sample counts (the reference derives
    them from the hardcoded fs=30: win_n = max(3, round(win_sec*30)),
    step_n = max(1, round(step_sec*30))).
    """
    n = vx.shape[0]
    if n < min_samples or n < win_n:
        return jnp.full((n,), jnp.nan, dtype=vx.dtype)

    centers, acc_idx, a_count, w_acc, valid = window_axes(
        vx, vy, win_n, step_n, min_samples, ref
    )
    k = centers.shape[0]

    # Compact accepted centers, padded with a sentinel beyond the end so
    # searchsorted never selects a padding slot.
    big = jnp.iinfo(jnp.int32).max
    slot = jnp.arange(k)
    c_acc = jnp.where(slot < a_count, centers[acc_idx], big)

    i = jnp.arange(n, dtype=jnp.int32)
    j = jnp.searchsorted(c_acc, i, side="left")
    j = jnp.clip(j, 0, jnp.maximum(a_count - 1, 0))
    j2 = jnp.maximum(j - 1, 0)
    # Strictly-closer → earlier center; ties → later (optical_PCA.py:225).
    d2 = jnp.abs(i - c_acc[j2])
    d1 = jnp.abs(i - c_acc[j])
    pick = jnp.where(d2 < d1, j2, j)

    e1 = w_acc[pick]  # (N, 2)
    pc1 = vx * e1[:, 0] + vy * e1[:, 1]
    ok = (
        jnp.isfinite(vx)
        & jnp.isfinite(vy)
        & jnp.isfinite(e1[:, 0])
        & jnp.isfinite(e1[:, 1])
        & (a_count > 0)
    )
    return jnp.where(ok, pc1, jnp.nan)
