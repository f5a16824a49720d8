"""Height-sharded full Farnebäck flow (shard_map + halo exchange).

SURVEY.md §2.6 "spatial tiling": when one frame is too large for a
single chip (or to cut per-frame latency), the image height is sharded
over a mesh axis.  Every stencil stage of the Farnebäck solver
(level-image blur+resize, polynomial expansion, winsize averaging)
exchanges only its halo rows with neighbor shards
(`lax.ppermute` inside one shard_map), while the warp stage exchanges a
``warp_halo``-row band of the second frame's expansion coefficients.
Communication per frame pair is O(halo · W) per stencil; compute stays
O(H_loc · W) per chip.

Coarse pyramid levels whose per-shard height would drop below the
stencil support are computed *replicated* (one `all_gather` of the tiny
level image, identical full-frame math on every shard) — they carry
~4^-k of the FLOPs, so gathering them costs ~nothing while keeping the
fine, expensive levels fully sharded.

Semantics vs the unsharded path (``ops.farneback.farneback_flow``):
bit-equal whenever every pixel's vertical
displacement satisfies |dy| <= warp_halo - 1; larger displacements fall
back to the same "outside the image" handling OpenCV applies at
borders (r0-only constraint) instead of silently reading wrong rows.

Reference: cv2.calcOpticalFlowFarneback (optical_flow.py:173); the
reference has no multi-device story (SURVEY.md §2.6) — this component
is pure framework capability.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from btcs_pnes_optical_flow.config import FarnebackParams, _round_half_even
from btcs_pnes_optical_flow.ops import cvx
from btcs_pnes_optical_flow.ops import farneback as fb
from btcs_pnes_optical_flow.parallel.halo import exchange_rows


def _level_image_sharded(img_loc, k, params, axis_name):
    """Local slice of the level-k image from the local full-res slice.

    Mirrors fb._level_image's strided blur+resize (pyr_scale=0.5, even
    sizes) with the vertical reflect101 pad supplied by halo exchange.
    """
    scale = params.pyr_scale**k
    sigma = (1.0 / scale - 1.0) * 0.5
    smooth_sz = max(_round_half_even(sigma * 5) | 1, 3)
    p = smooth_sz // 2
    if k == 0:
        kern = cvx.gaussian_kernel(smooth_sz, sigma)
        ext = exchange_rows(img_loc, p, axis_name, "reflect101")
        ext = cvx.pad_reflect101(ext, 0, p)
        v = cvx.corr1d(ext, kern, axis=-2)
        return cvx.corr1d(v, kern, axis=-1)
    m = 2**k
    g = cvx.gaussian_kernel(smooth_sz, sigma)
    comb = np.convolve(g, [0.5, 0.5])
    start = (m - 2) // 2
    h_out = img_loc.shape[-2] // m
    w_out = img_loc.shape[-1] // m
    ext = exchange_rows(img_loc, p, axis_name, "reflect101")
    ext = cvx.pad_reflect101(ext, 0, p)
    v = fb._strided_corr1d(ext, comb, m, start, h_out, axis=-2)
    return fb._strided_corr1d(v, comb, m, start, w_out, axis=-1)


def _poly_exp_sharded(img_loc, n, sigma, axis_name):
    ext = exchange_rows(img_loc, n, axis_name, "replicate")
    return fb.poly_exp_padded(cvx.pad_replicate(ext, 0, n), n, sigma)


def _upsample2x_rows(x, axis_name):
    """Vertical ×2 bilinear upsample of local (..., h, w) rows, matching
    cvx.resize_bilinear's (d+0.5)/2-0.5 sampling across shard seams."""
    ext = exchange_rows(x, 1, axis_name, "replicate")
    a = ext[..., :-2, :]
    b = ext[..., 1:-1, :]
    c = ext[..., 2:, :]
    even = 0.25 * a + 0.75 * b
    odd = 0.75 * b + 0.25 * c
    out = jnp.stack([even, odd], axis=-2)  # (..., h, 2, w)
    return out.reshape(x.shape[:-2] + (2 * x.shape[-2], x.shape[-1]))


@functools.lru_cache(maxsize=None)
def _sx_border(w: int) -> np.ndarray:
    sx = np.ones(w, dtype=np.float32)
    for i, v in enumerate(fb._BORDER_SCALE):
        if i < w:
            sx[i] *= v
        if w - 1 - i >= 0:
            sx[w - 1 - i] *= v
    return sx


def _update_matrices_sharded(r0, r1, flow, H_glob, warp_halo, axis_name):
    """update_matrices on a height shard: r1 rows beyond the local block
    come from a warp_halo exchange; warp targets outside the halo are
    treated like out-of-image targets (r0-only fallback)."""
    b, h_loc, w, _ = r0.shape
    dt = r0.dtype
    K = min(warp_halo, h_loc)
    idx = jax.lax.axis_index(axis_name)
    off = idx * h_loc

    dx = flow[..., 0]
    dy = flow[..., 1]
    gx = jnp.arange(w, dtype=dt)[None, None, :]
    gy = (off.astype(dt) + jnp.arange(h_loc, dtype=dt))[None, :, None]
    fx = gx + dx
    fy = gy + dy

    x1i = jnp.floor(fx).astype(jnp.int32)
    y1i = jnp.floor(fy).astype(jnp.int32)
    ax = (fx - jnp.floor(fx))[..., None]
    ay = (fy - jnp.floor(fy))[..., None]
    inside = (x1i >= 0) & (x1i < w - 1) & (y1i >= 0) & (y1i < H_glob - 1)
    y_ext = y1i - off + K  # row of the floor corner inside the ext block
    h_ext = h_loc + 2 * K
    inside = inside & (y_ext >= 0) & (y_ext <= h_ext - 2)

    r1m = jnp.moveaxis(r1, -1, 1)  # (B, 5, h, w)
    ext = jnp.moveaxis(exchange_rows(r1m, K, axis_name, "replicate"), 1, -1)

    x0c = jnp.clip(x1i, 0, w - 1)
    x1c = jnp.clip(x1i + 1, 0, w - 1)
    y0c = jnp.clip(y_ext, 0, h_ext - 1)
    y1c = jnp.clip(y_ext + 1, 0, h_ext - 1)
    flat = ext.reshape(b, h_ext * w, 5)

    def take(yi, xi):
        lin = yi * w + xi
        return jnp.take_along_axis(flat, lin.reshape(b, -1, 1), axis=1).reshape(
            b, h_loc, w, 5
        )

    v00 = take(y0c, x0c)
    v01 = take(y0c, x1c)
    v10 = take(y1c, x0c)
    v11 = take(y1c, x1c)
    top = v00 * (1.0 - ax) + v01 * ax
    bot = v10 * (1.0 - ax) + v11 * ax
    sampled = top * (1.0 - ay) + bot * ay

    g_row = off + jnp.arange(h_loc)
    sy = jnp.ones(h_loc, dt)
    for i, v in enumerate(fb._BORDER_SCALE):
        sy = jnp.where((g_row == i) | (g_row == H_glob - 1 - i), sy * v, sy)
    scale = (sy[:, None] * jnp.asarray(_sx_border(w))[None, :])[None]
    return fb.update_matrices_core(r0, sampled, inside, dx, dy, scale)


def _update_flow_sharded(m, winsize, gaussian_win, axis_name):
    mm = jnp.moveaxis(m, -1, 1)  # (B, 5, h, w)
    p = winsize // 2
    if gaussian_win:
        k = fb._gaussian_win_kernel(winsize)
        post = 1.0
    else:
        k = np.ones(winsize, dtype=np.float64)
        post = 1.0 / (winsize * winsize)
    ext = exchange_rows(mm, p, axis_name, "replicate")
    ext = cvx.pad_replicate(ext, 0, p)
    v = cvx.corr1d(ext, k, axis=-2)
    msum = cvx.corr1d(v, k, axis=-1)
    if post != 1.0:
        msum = msum * post
    return fb.solve_flow(msum)


def _local_flow(p_blk, c_blk, *, params, H, W, n_shards, klev, warp_halo, axis_name):
    """Per-shard body of the sharded solver (runs inside shard_map)."""
    dt = jnp.float32
    p_f = p_blk.astype(dt)
    c_f = c_blk.astype(dt)
    min_rows = max(params.poly_n, params.winsize // 2)
    idx = jax.lax.axis_index(axis_name)

    flow = None
    flow_replicated = False
    for k in range(klev, -1, -1):
        hk, wk = H >> k, W >> k
        h_loc = hk // n_shards
        i0 = _level_image_sharded(p_f, k, params, axis_name)
        i1 = _level_image_sharded(c_f, k, params, axis_name)
        sharded = h_loc >= min_rows

        if not sharded:
            # Tiny coarse level: gather it and run the full-frame math
            # replicated on every shard (≤ 4^-k of total FLOPs).
            i0 = jax.lax.all_gather(i0, axis_name, axis=1, tiled=True)
            i1 = jax.lax.all_gather(i1, axis_name, axis=1, tiled=True)
            r0 = fb.poly_exp(i0, params.poly_n, params.poly_sigma)
            r1 = fb.poly_exp(i1, params.poly_n, params.poly_sigma)
        else:
            r0 = _poly_exp_sharded(i0, params.poly_n, params.poly_sigma, axis_name)
            r1 = _poly_exp_sharded(i1, params.poly_n, params.poly_sigma, axis_name)

        # ---- carry flow from the previous (coarser) level --------------
        if flow is None:
            rows = hk if not sharded else h_loc
            flow = jnp.zeros((p_f.shape[0], rows, wk, 2), dt)
        else:
            fm = jnp.moveaxis(flow, -1, 1)  # (B, 2, h, w)
            if flow_replicated:
                fm = cvx.resize_bilinear(fm, 2 * fm.shape[-2], wk)
            else:
                fm = _upsample2x_rows(fm, axis_name)
                fm = cvx.resize_bilinear(fm, fm.shape[-2], wk)
            flow = jnp.moveaxis(fm, 1, -1) * (1.0 / params.pyr_scale)
            if flow_replicated and sharded:
                flow = jax.lax.dynamic_slice_in_dim(flow, idx * h_loc, h_loc, axis=1)
            elif (not flow_replicated) and (not sharded):  # pragma: no cover
                flow = jax.lax.all_gather(flow, axis_name, axis=1, tiled=True)
        flow_replicated = not sharded

        # ---- refinement iterations --------------------------------------
        if sharded:
            m = _update_matrices_sharded(r0, r1, flow, hk, warp_halo, axis_name)
            for it in range(params.iterations):
                flow = _update_flow_sharded(
                    m, params.winsize, params.gaussian_win, axis_name
                )
                if it < params.iterations - 1:
                    m = _update_matrices_sharded(
                        r0, r1, flow, hk, warp_halo, axis_name
                    )
        else:
            m = fb.update_matrices(r0, r1, flow)
            for it in range(params.iterations):
                flow = fb.update_flow(m, params.winsize, params.gaussian_win)
                if it < params.iterations - 1:
                    m = fb.update_matrices(r0, r1, flow)

    if flow_replicated:  # level 0 replicated (only for very small frames)
        h_loc = H // n_shards
        flow = jax.lax.dynamic_slice_in_dim(flow, idx * h_loc, h_loc, axis=1)
    return flow


def farneback_flow_sharded(
    prev: jnp.ndarray,
    curr: jnp.ndarray,
    params: FarnebackParams = FarnebackParams(),
    mesh: Optional[Mesh] = None,
    axis_name: str = "spatial",
    warp_halo: int = 16,
) -> jnp.ndarray:
    """Dense Farnebäck flow with the image height sharded over `mesh`.

    prev, curr: (B, H, W) uint8/float (or (H, W)); returns (B, H, W, 2)
    sharded as P(None, axis_name, None, None).  Requires
    H % (n_shards * 2**num_levels) == 0 and W % 2**num_levels == 0 and
    pyr_scale == 0.5 (the production configuration).
    """
    if mesh is None:
        raise ValueError("farneback_flow_sharded requires a mesh")
    if prev.ndim == 2:
        prev, curr = prev[None], curr[None]
        squeeze = True
    else:
        squeeze = False
    B, H, W = prev.shape
    n = mesh.shape[axis_name]
    klev = params.num_levels(H, W)
    if params.pyr_scale != 0.5:
        raise ValueError("sharded path requires pyr_scale=0.5")
    if params.use_initial_flow:
        raise ValueError("sharded path does not take an initial flow")
    if H % (n * (1 << klev)):
        raise ValueError(
            f"H={H} must be divisible by n_shards*2^levels={n * (1 << klev)}"
        )
    if W % (1 << klev):
        raise ValueError(f"W={W} must be divisible by 2^levels={1 << klev}")

    spec = P(None, axis_name, None)
    local = functools.partial(
        _local_flow,
        params=params,
        H=H,
        W=W,
        n_shards=n,
        klev=klev,
        warp_halo=warp_halo,
        axis_name=axis_name,
    )
    fn = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(spec, spec),
            out_specs=P(None, axis_name, None, None),
            check_vma=False,
        )
    )
    sh = NamedSharding(mesh, spec)
    out = fn(jax.device_put(prev, sh), jax.device_put(curr, sh))
    return out[0] if squeeze else out
