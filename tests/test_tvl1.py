"""TV-L1 variational flow: convergence on known motion."""

import numpy as np
import pytest

import jax.numpy as jnp

from btcs_pnes_optical_flow.ops.tvl1 import TVL1Params, tvl1_flow


def _texture(h, w, rng, shift=(0.0, 0.0)):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xx = xx + shift[0]
    yy = yy + shift[1]
    img = (np.sin(xx / 6) * np.cos(yy / 7) + 0.6 * np.sin(xx / 11 + yy / 5)) * 55 + 128
    return np.clip(img + rng.normal(0, 1, (h, w)), 0, 255).astype(np.uint8)


def test_tvl1_recovers_translation(rng):
    h, w = 64, 80
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(1.2, -0.7))
    flow = np.asarray(tvl1_flow(jnp.asarray(f0), jnp.asarray(f1)))
    inner = flow[12:-12, 12:-12]
    # The warp convention: I1 sampled at x+flow matches I0 → flow ≈ -shift... or +
    epe_a = np.sqrt((inner[..., 0] + 1.2) ** 2 + (inner[..., 1] - 0.7) ** 2).mean()
    epe_b = np.sqrt((inner[..., 0] - 1.2) ** 2 + (inner[..., 1] + 0.7) ** 2).mean()
    assert min(epe_a, epe_b) < 0.25, (epe_a, epe_b)


def test_tvl1_zero_motion(rng):
    f0 = _texture(48, 56, rng)
    flow = np.asarray(tvl1_flow(jnp.asarray(f0), jnp.asarray(f0)))
    assert np.abs(flow).max() < 0.05


def test_tvl1_rotation_epe(rng):
    """Non-trivial (rotational) motion: EPE vs the known ground-truth
    field must stay under 0.15 px in the interior, beyond the pure
    translations of the other tests."""
    h, w = 96, 112
    cy, cx = (h - 1) / 2, (w - 1) / 2
    ang = 0.02  # ~1.5 px peak displacement in the asserted interior
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # I1(x) = T(R x): sample the base texture at the forward-rotated
    # coordinates; the flow satisfying I1(x + f) = I0(x) = T(x) is then
    # f(x) = R^-1 x - x (the INVERSE rotation's displacement field).
    dxf = (xx - cx) * np.cos(ang) - (yy - cy) * np.sin(ang) + cx - xx
    dyf = (xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang) + cy - yy
    dxp = (xx - cx) * np.cos(-ang) - (yy - cy) * np.sin(-ang) + cx - xx
    dyp = (xx - cx) * np.sin(-ang) + (yy - cy) * np.cos(-ang) + cy - yy

    def tex(sx, sy):
        # Sharp multi-frequency texture: TV-L1's saturated prox step
        # moves lambda*theta*|grad I| px per iteration, so gradient-poor
        # textures converge impractically slowly at test budgets.
        x2, y2 = xx + sx, yy + sy
        img = (
            np.sin(x2 / 2.1) * np.cos(y2 / 2.6)
            + np.sin(x2 / 6 + y2 / 4.2)
            + 0.8 * np.cos(x2 / 3.4 - y2 / 2.9)
        ) * 42 + 128
        return np.clip(img, 0, 255).astype(np.float32)

    f0 = tex(0, 0)
    f1 = tex(dxf, dyf)
    flow = np.asarray(
        tvl1_flow(jnp.asarray(f0), jnp.asarray(f1), TVL1Params(n_scales=2))
    )
    inner = np.s_[16:-16, 16:-16]
    epe = np.sqrt(
        (flow[..., 0] - dxp)[inner] ** 2 + (flow[..., 1] - dyp)[inner] ** 2
    ).mean()
    assert epe < 0.15, epe


def test_tvl1_epsilon_early_stop(rng):
    """epsilon is live: a loose threshold must
    converge in fewer effective iterations yet stay close to the full
    run on easy motion; epsilon=0 reproduces the fixed-count behavior."""
    h, w = 48, 56
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(0.6, 0.3))
    full = np.asarray(
        tvl1_flow(jnp.asarray(f0), jnp.asarray(f1), TVL1Params(epsilon=0.0))
    )
    loose = np.asarray(
        tvl1_flow(jnp.asarray(f0), jnp.asarray(f1), TVL1Params(epsilon=0.002))
    )
    # Same motion estimate to within a tenth of a pixel...
    assert np.abs(loose - full).max() < 0.1
    # ...and the loose run is genuinely allowed to differ (it stopped
    # early), so it should not be bit-identical.
    assert np.abs(loose - full).max() > 0


def test_tvl1_batched(rng):
    f0 = _texture(48, 56, rng)
    f1 = _texture(48, 56, rng, shift=(0.8, 0.4))
    single = np.asarray(tvl1_flow(jnp.asarray(f0), jnp.asarray(f1)))
    batched = np.asarray(
        tvl1_flow(jnp.asarray(np.stack([f0, f0])), jnp.asarray(np.stack([f1, f1])))
    )
    np.testing.assert_allclose(batched[0], single, atol=1e-4)
    np.testing.assert_allclose(batched[1], single, atol=1e-4)


def _np_tvl1_single_level(prev_u8, curr_u8, n_warps=3, n_iterations=30,
                          tau=0.25, lambda_=0.3, theta=0.3):
    """Independent dense float64 NumPy oracle of single-level
    Zach–Pock–Bischof TV-L1 (the published primal–dual algorithm, per
    the IPOL Sánchez et al. description) — written against the math,
    not against ops/tvl1.py, so it cross-checks the JAX engine the way
    tests/reference_impl.py cross-checks the Farnebäck chain."""
    from scipy.ndimage import correlate1d

    # cv2.getGaussianKernel(5, 0.8) formula.
    i = np.arange(5) - 2
    k = np.exp(-(i * i) / (2 * 0.8 * 0.8))
    k /= k.sum()

    def blur(img):
        # BORDER_REFLECT_101 == scipy 'mirror'.
        return correlate1d(correlate1d(img, k, axis=0, mode="mirror"),
                           k, axis=1, mode="mirror")

    def grad(f):  # forward differences, zero at the far edge
        gx = np.zeros_like(f)
        gy = np.zeros_like(f)
        gx[:, :-1] = f[:, 1:] - f[:, :-1]
        gy[:-1, :] = f[1:, :] - f[:-1, :]
        return gx, gy

    def div(px, py):  # backward-difference divergence (adjoint of grad)
        dx = np.zeros_like(px)
        dx[:, 0] = px[:, 0]
        dx[:, 1:-1] = px[:, 1:-1] - px[:, :-2]
        dx[:, -1] = -px[:, -2]
        dy = np.zeros_like(py)
        dy[0, :] = py[0, :]
        dy[1:-1, :] = py[1:-1, :] - py[:-2, :]
        dy[-1, :] = -py[-2, :]
        return dx + dy

    h, w = prev_u8.shape

    def warp(img, u, v):  # clamped bilinear sample at (x+u, y+v)
        gx = np.clip(np.arange(w)[None, :] + u, 0.0, w - 1.0)
        gy = np.clip(np.arange(h)[None, :].T + v, 0.0, h - 1.0)
        x0 = np.floor(gx).astype(int)
        y0 = np.floor(gy).astype(int)
        fx = gx - x0
        fy = gy - y0
        x1 = np.clip(x0 + 1, 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
        bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
        return top * (1 - fy) + bot * fy

    i0 = blur(prev_u8.astype(np.float64) / 255.0)
    i1 = blur(curr_u8.astype(np.float64) / 255.0)
    l_t = lambda_ * theta
    tt = tau / theta
    u = np.zeros((h, w))
    v = np.zeros((h, w))
    for _ in range(n_warps):
        p11 = np.zeros((h, w)); p12 = np.zeros((h, w))
        p21 = np.zeros((h, w)); p22 = np.zeros((h, w))
        i1x, i1y = grad(i1)
        u0, v0 = u.copy(), v.copy()
        i1w = warp(i1, u0, v0)
        i1wx = warp(i1x, u0, v0)
        i1wy = warp(i1y, u0, v0)
        grad_sq = i1wx ** 2 + i1wy ** 2
        rho_c = i1w - i1wx * u0 - i1wy * v0 - i0
        for _it in range(n_iterations):
            rho = rho_c + i1wx * u + i1wy * v
            lo = rho < -l_t * grad_sq
            hi = rho > l_t * grad_sq
            mid = ~(lo | hi)
            d1 = np.where(lo, l_t * i1wx, np.where(hi, -l_t * i1wx,
                          -rho * i1wx / np.maximum(grad_sq, 1e-9)))
            d2 = np.where(lo, l_t * i1wy, np.where(hi, -l_t * i1wy,
                          -rho * i1wy / np.maximum(grad_sq, 1e-9)))
            del mid
            u_new = u + d1 + theta * div(p11, p12)
            v_new = v + d2 + theta * div(p21, p22)
            ux, uy = grad(u_new)
            vx, vy = grad(v_new)
            ng_u = np.sqrt(ux * ux + uy * uy)
            ng_v = np.sqrt(vx * vx + vy * vy)
            p11 = (p11 + tt * ux) / (1 + tt * ng_u)
            p12 = (p12 + tt * uy) / (1 + tt * ng_u)
            p21 = (p21 + tt * vx) / (1 + tt * ng_v)
            p22 = (p22 + tt * vy) / (1 + tt * ng_v)
            u, v = u_new, v_new
    return np.stack([u, v], axis=-1)


def test_tvl1_matches_numpy_oracle(rng):
    """The JAX engine (epsilon=0, single level) must
    track the independent float64 NumPy Zach–Pock oracle pointwise and
    both must recover a known translation."""
    h, w = 64, 96
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(0.6, -0.4))
    # Single-level convergence needs a real budget: (10, 100) reaches
    # EPE 0.012 on this texture, (5, 50) stalls at 0.40.
    p = TVL1Params(n_scales=1, n_warps=10, n_iterations=100, epsilon=0.0)
    got = np.asarray(tvl1_flow(jnp.asarray(f0), jnp.asarray(f1), p))
    ref = _np_tvl1_single_level(f0, f1, n_warps=10, n_iterations=100)
    # fp32 engine vs fp64 oracle over 1000 coupled iterations.
    assert np.abs(got - ref).max() < 2e-2, np.abs(got - ref).max()
    inner = ref[12:-12, 12:-12]
    epe = np.sqrt((inner[..., 0] + 0.6) ** 2 + (inner[..., 1] - 0.4) ** 2).mean()
    assert epe < 0.25, epe


def test_tvl1_matches_numpy_oracle_second_size(rng):
    """Same oracle check at a second, non-square size with an odd
    width, where the divergence and warp edges land differently."""
    h, w = 40, 57
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(-0.5, 0.3))
    p = TVL1Params(n_scales=1, n_warps=6, n_iterations=60, epsilon=0.0)
    got = np.asarray(tvl1_flow(jnp.asarray(f0), jnp.asarray(f1), p))
    ref = _np_tvl1_single_level(f0, f1, n_warps=6, n_iterations=60)
    assert np.abs(got - ref).max() < 2e-2, np.abs(got - ref).max()
