"""Dense Farnebäck optical flow in pure XLA (batched, jittable).

Re-implementation of the algorithm behind
``cv2.calcOpticalFlowFarneback`` (reference call site:
optical_flow.py:173 with FB_PARAMS optical_flow.py:48-56) — the
component that is ~99% of the reference pipeline's runtime
(SURVEY.md §3.1).  Built from the Farnebäck 2003 formulation
("Two-frame motion estimation based on polynomial expansion") plus the
behavioral details OpenCV's C++ adds, which the differential tests pin
to <0.1 px EPE:

- per-level images are produced by Gaussian-smoothing the *full-res*
  frame with sigma = (1/scale - 1)/2 and bilinearly resizing straight
  to the level size (not an iterated pyrDown);
- polynomial expansion solves the Gaussian-weighted LS fit
  f ≈ c + b·x + x^T A x via separable correlations with replicate
  borders, keeping 5 coefficient planes (b_y, b_x, A_yy, A_xx, 2A_xy);
- each iteration warps the second image's coefficients by the current
  flow (bilinear), averages A across frames, folds the displacement
  into Δb, damps a 5-pixel rim, accumulates the 2×2 normal equations
  G = Â^T Â and h = Â^T Δb/2, box- (or Gaussian-) averages them over
  winsize², and solves the regularized 2×2 system per pixel;
- flow is upsampled ×(1/pyr_scale) between levels.

Everything is expressed as separable stencils, one bilinear gather
and elementwise math, left to XLA to fuse; the batch dimension (frame
pairs × videos) provides the parallel scale.  Each stage runs under a
``jax.named_scope`` (level_image, poly_exp, update_matrices,
update_flow, resize_flow) so a profiler trace attributes device time
per stage.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from btcs_pnes_optical_flow.config import FarnebackParams
from btcs_pnes_optical_flow.ops import cvx

# Rim damping applied to the normal equations near the image border
# (5-pixel ramp; suppresses the unreliable constraints there).
_BORDER = 5
_BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


@functools.lru_cache(maxsize=None)
def _poly_exp_tables(n: int, sigma: float):
    """Gaussian applicability kernels + inverse-Gram factors (host, f64).

    The LS fit of f over basis (1, x, y, x², y², xy) with separable
    weight w(x,y)=g(x)g(y) has Gram matrix G whose inverse supplies the
    four factors needed to turn raw correlations into coefficients.
    """
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    basis = []
    w = []
    for yy in x:
        for xx in x:
            w.append(g[int(yy) + n] * g[int(xx) + n])
            basis.append([1.0, xx, yy, xx * xx, yy * yy, xx * yy])
    bmat = np.asarray(basis)
    wv = np.asarray(w)
    gram = bmat.T @ (bmat * wv[:, None])
    ginv = np.linalg.inv(gram)
    ig11 = ginv[1, 1]
    ig03 = ginv[0, 3]
    ig33 = ginv[3, 3]
    ig55 = ginv[5, 5]
    return g, xg, xxg, (ig11, ig03, ig33, ig55)


def poly_exp(img: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """Quadratic polynomial expansion → (B, H, W, 5) coefficients.

    Channels: [b_y, b_x, A_yy, A_xx, 2·A_xy] (the xy channel carries
    the full mixed coefficient; downstream code halves it).
    Borders: replicate.
    """
    return poly_exp_padded(cvx.pad_replicate(img, n, n), n, sigma)


def poly_exp_padded(xpad: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """poly_exp on an input already padded by n on both spatial axes.

    Used directly by the height-sharded path (parallel/spatial.py),
    where the vertical pad rows come from a halo exchange instead of
    edge replication.
    """
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_exp_tables(n, sigma)
    # Vertical pass (offsets along y; xg is odd → signed kernel).
    t0 = cvx.corr1d(xpad, g, axis=-2)
    t1 = cvx.corr1d(xpad, xg, axis=-2)
    t2 = cvx.corr1d(xpad, xxg, axis=-2)
    # Horizontal pass.
    b1 = cvx.corr1d(t0, g, axis=-1)
    b2 = cvx.corr1d(t0, xg, axis=-1)
    b4 = cvx.corr1d(t0, xxg, axis=-1)
    b3 = cvx.corr1d(t1, g, axis=-1)
    b6 = cvx.corr1d(t1, xg, axis=-1)
    b5 = cvx.corr1d(t2, g, axis=-1)

    r_by = b3 * ig11
    r_bx = b2 * ig11
    r_ayy = b1 * ig03 + b5 * ig33
    r_axx = b1 * ig03 + b4 * ig33
    r_axy = b6 * ig55
    return jnp.stack([r_by, r_bx, r_ayy, r_axx, r_axy], axis=-1)


def _bilinear_gather(r1: jnp.ndarray, fx: jnp.ndarray, fy: jnp.ndarray):
    """Bilinear sample of (B, H, W, C) at absolute coords (fx, fy).

    Returns (sampled (B,H,W,C), inside (B,H,W)) where `inside` mirrors
    OpenCV's guard: floor coords within [0, W-2] × [0, H-2].

    Four per-corner gathers via take_along_axis; XLA fuses them with
    the lerp.  Out-of-image targets are clamped for the read and
    flagged by `inside`.
    """
    b, h, w, c = r1.shape
    x1 = jnp.floor(fx)
    y1 = jnp.floor(fy)
    ax = (fx - x1)[..., None]
    ay = (fy - y1)[..., None]
    x1i = x1.astype(jnp.int32)
    y1i = y1.astype(jnp.int32)
    inside = (x1i >= 0) & (x1i < w - 1) & (y1i >= 0) & (y1i < h - 1)
    x0c = jnp.clip(x1i, 0, w - 1)
    y0c = jnp.clip(y1i, 0, h - 1)
    x1c = jnp.clip(x1i + 1, 0, w - 1)
    y1c = jnp.clip(y1i + 1, 0, h - 1)

    flat = r1.reshape(b, h * w, c)

    def take(yi, xi):
        lin = yi * w + xi
        return jnp.take_along_axis(flat, lin.reshape(b, h * w, 1), axis=1).reshape(
            b, h, w, c
        )

    v00 = take(y0c, x0c)
    v01 = take(y0c, x1c)
    v10 = take(y1c, x0c)
    v11 = take(y1c, x1c)
    top = v00 * (1.0 - ax) + v01 * ax
    bot = v10 * (1.0 - ax) + v11 * ax
    return top * (1.0 - ay) + bot * ay, inside


@functools.lru_cache(maxsize=None)
def _border_scale_np(h: int, w: int) -> np.ndarray:
    sy = np.ones(h, dtype=np.float32)
    sx = np.ones(w, dtype=np.float32)
    for i, v in enumerate(_BORDER_SCALE):
        if i < h:
            sy[i] *= v
        if h - 1 - i >= 0:
            sy[h - 1 - i] *= v
        if i < w:
            sx[i] *= v
        if w - 1 - i >= 0:
            sx[w - 1 - i] *= v
    return sy[:, None] * sx[None, :]


def update_matrices(r0: jnp.ndarray, r1: jnp.ndarray, flow: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel normal equations (G, h) from the two expansions + flow.

    flow: (B, H, W, 2) with channels (dx, dy).  Output (B, H, W, 5):
    [G_yy, G_xy, G_xx, h_y, h_x].
    """
    b, h, w, _ = r0.shape
    dt = r0.dtype
    dx = flow[..., 0]
    dy = flow[..., 1]
    gx = jnp.arange(w, dtype=dt)[None, None, :]
    gy = jnp.arange(h, dtype=dt)[None, :, None]
    sampled, inside = _bilinear_gather(r1, gx + dx, gy + dy)
    scale = jnp.asarray(_border_scale_np(h, w), dt)[None, :, :]
    return update_matrices_core(r0, sampled, inside, dx, dy, scale)


def update_matrices_core(r0, sampled, inside, dx, dy, scale) -> jnp.ndarray:
    """M-plane math shared by the exact and height-sharded paths.

    `sampled` is r1 bilinearly warped to (x+dx, y+dy); `inside` marks
    warp targets whose 2×2 support lies fully inside the *global*
    image; `scale` is the 5-pixel rim damping for the pixel's global
    position.
    """
    r2s = sampled[..., 0]
    r3s = sampled[..., 1]
    r4s = sampled[..., 2]
    r5s = sampled[..., 3]
    r6s = sampled[..., 4]

    r4 = jnp.where(inside, (r0[..., 2] + r4s) * 0.5, r0[..., 2])
    r5 = jnp.where(inside, (r0[..., 3] + r5s) * 0.5, r0[..., 3])
    r6 = jnp.where(inside, (r0[..., 4] + r6s) * 0.25, r0[..., 4] * 0.5)

    r2 = (r0[..., 0] - jnp.where(inside, r2s, 0.0)) * 0.5
    r3 = (r0[..., 1] - jnp.where(inside, r3s, 0.0)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    m0 = r4 * r4 + r6 * r6
    m1 = (r4 + r5) * r6
    m2 = r5 * r5 + r6 * r6
    m3 = r4 * r2 + r6 * r3
    m4 = r6 * r2 + r5 * r3
    return jnp.stack([m0, m1, m2, m3, m4], axis=-1)


@functools.lru_cache(maxsize=None)
def _gaussian_win_kernel(winsize: int) -> np.ndarray:
    m = winsize // 2
    sigma = m * 0.3
    x = np.arange(-m, m + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def update_flow(m: jnp.ndarray, winsize: int, gaussian_win: bool) -> jnp.ndarray:
    """Average the normal equations over the window and solve per pixel."""
    mm = jnp.moveaxis(m, -1, 1)  # (B, 5, H, W) so the stencil runs on 2D planes
    if gaussian_win:
        k = _gaussian_win_kernel(winsize)
        msum = cvx.sep_corr_replicate(mm, k, k)
    else:
        msum = cvx.box_sum_replicate(mm, winsize) * (1.0 / (winsize * winsize))
    return solve_flow(msum)


def solve_flow(msum: jnp.ndarray) -> jnp.ndarray:
    """Regularized per-pixel 2×2 solve of the window-averaged normal
    equations (msum: (B, 5, H, W)) → flow (B, H, W, 2)."""
    g11 = msum[:, 0]
    g12 = msum[:, 1]
    g22 = msum[:, 2]
    h1 = msum[:, 3]
    h2 = msum[:, 4]
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return jnp.stack([fx, fy], axis=-1)


def _strided_corr1d(img, kernel, stride: int, start: int, n_out: int, axis: int):
    """Strided 1-D correlation (pre-padded input): out[d] = Σ k[i]·x[start + d·stride + i]."""
    karr = np.asarray(kernel, dtype=np.float64)
    klen = len(karr)
    lead = img.shape[: img.ndim - 2]
    nb = int(np.prod(lead)) if lead else 1
    axis = axis % img.ndim
    # Trim so the VALID strided conv yields exactly n_out outputs.
    need = start + (n_out - 1) * stride + klen
    if axis == img.ndim - 2:
        x = img[..., start:need, :]
        rhs = np.broadcast_to(karr.reshape(1, 1, klen, 1), (nb, 1, klen, 1))
        strides = (stride, 1)
    else:
        x = img[..., :, start:need]
        rhs = np.broadcast_to(karr.reshape(1, 1, 1, klen), (nb, 1, 1, klen))
        strides = (1, stride)
    y = jax.lax.conv_general_dilated(
        x.reshape((1, nb) + x.shape[-2:]),
        jnp.asarray(rhs, img.dtype),
        window_strides=strides,
        padding="VALID",
        feature_group_count=nb,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(lead + y.shape[-2:])


def _level_image(img_f: jnp.ndarray, k: int, params: FarnebackParams, h: int, w: int):
    """Full-res float image → smoothed + resized level-k image.

    OpenCV semantics: GaussianBlur the *full-res* frame with
    sigma = (1/scale - 1)/2 (reflect101 borders), then bilinear-resize
    to the level size.  For the standard pyr_scale = 0.5 pyramid with
    even level sizes, blur+resize collapses into one *strided*
    correlation with kernel gauss ⊛ [0.5, 0.5] — bilinear sample
    positions (d+0.5)·2^k − 0.5 fall exactly halfway between two
    integer pixels — which costs O(output) instead of O(full-res)
    per level.  Exact (same taps, same weights); odd sizes or other
    scales fall back to the generic blur+resize.
    """
    scale = params.pyr_scale**k
    sigma = (1.0 / scale - 1.0) * 0.5
    from btcs_pnes_optical_flow.config import _round_half_even

    smooth_sz = max(_round_half_even(sigma * 5) | 1, 3)
    hk, wk = params.level_size(h, w, k)

    if k > 0 and params.pyr_scale == 0.5 and (h, w) == (hk * 2**k, wk * 2**k):
        m = 2**k
        g = cvx.gaussian_kernel(smooth_sz, sigma)
        comb = np.convolve(g, [0.5, 0.5])  # blur ⊛ bilinear half-taps
        p = smooth_sz // 2
        xp = cvx.pad_reflect101(img_f, p, p)
        # out[d] reads padded positions (m·d + (m-2)/2 - p) + [0, 2p+1].
        start = (m - 2) // 2
        v = _strided_corr1d(xp, comb, m, start, hk, axis=-2)
        return _strided_corr1d(v, comb, m, start, wk, axis=-1), hk, wk

    sm = cvx.gaussian_blur_reflect101(img_f, smooth_sz, sigma)
    return cvx.resize_bilinear(sm, hk, wk), hk, wk


@functools.partial(jax.jit, static_argnames=("params",))
def farneback_flow(
    prev: jnp.ndarray,
    curr: jnp.ndarray,
    params: FarnebackParams = FarnebackParams(),
    flow0: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Dense flow between two (batches of) grayscale frames.

    prev, curr: (B, H, W) uint8 or float; returns flow (B, H, W, 2)
    with channels (dx, dy) in pixels, matching
    cv2.calcOpticalFlowFarneback's output layout.
    """
    if prev.ndim == 2:
        prev = prev[None]
        curr = curr[None]
        if flow0 is not None and flow0.ndim == 3:
            flow0 = flow0[None]
        squeeze = True
    else:
        squeeze = False
    bsz, h, w = prev.shape
    dt = jnp.float32
    p_f = prev.astype(dt)
    c_f = curr.astype(dt)

    klev = params.num_levels(h, w)
    flow = None
    for k in range(klev, -1, -1):
        with jax.named_scope("level_image"):
            i0, hk, wk = _level_image(p_f, k, params, h, w)
            i1, _, _ = _level_image(c_f, k, params, h, w)
        with jax.named_scope("poly_exp"):
            r0 = poly_exp(i0, params.poly_n, params.poly_sigma)
            r1 = poly_exp(i1, params.poly_n, params.poly_sigma)

        with jax.named_scope("resize_flow"):
            if flow is None:
                if params.use_initial_flow and flow0 is not None:
                    scale = params.pyr_scale**k
                    fr = cvx.resize_bilinear(jnp.moveaxis(flow0, -1, 1), hk, wk)
                    flow = jnp.moveaxis(fr, 1, -1) * scale
                else:
                    flow = jnp.zeros((bsz, hk, wk, 2), dt)
            else:
                fr = cvx.resize_bilinear(jnp.moveaxis(flow, -1, 1), hk, wk)
                flow = jnp.moveaxis(fr, 1, -1) * (1.0 / params.pyr_scale)

        for _ in range(params.iters_at(k)):
            with jax.named_scope("update_matrices"):
                m = update_matrices(r0, r1, flow)
            with jax.named_scope("update_flow"):
                flow = update_flow(m, params.winsize, params.gaussian_win)

    return flow[0] if squeeze else flow


@functools.partial(jax.jit, static_argnames=("params",))
def farneback_flow_seq(
    frames: jnp.ndarray,
    params: FarnebackParams = FarnebackParams(),
) -> jnp.ndarray:
    """Flow for the N consecutive pairs of an (N+1, H, W) sequence.

    Equivalent to farneback_flow(frames[:-1], frames[1:], params): pair
    i is (frame i, frame i+1), the reference's carried prev_gray
    (optical_flow.py:242-249).
    """
    return farneback_flow(frames[:-1], frames[1:], params)
