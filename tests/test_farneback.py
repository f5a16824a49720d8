"""Kernel-level differential tests: Farnebäck flow vs OpenCV (SURVEY.md §4.2)."""

import numpy as np
import pytest

import jax.numpy as jnp

from btcs_pnes_optical_flow.config import FarnebackParams
from btcs_pnes_optical_flow.ops import cvx
from btcs_pnes_optical_flow.ops.farneback import farneback_flow, poly_exp


def _texture(h, w, rng, shift=(0.0, 0.0)):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xx = xx + shift[0]
    yy = yy + shift[1]
    img = (np.sin(xx / 7) * np.cos(yy / 9) + 0.5 * np.sin(xx / 3 + yy / 5)) * 60 + 128
    return np.clip(img + rng.normal(0, 1, (h, w)), 0, 255).astype(np.uint8)


def _epe(a, b):
    return np.sqrt(((a - b) ** 2).sum(-1))


@pytest.mark.parametrize("flags", [0, 256])  # box and Gaussian windows
def test_flow_matches_cv2(flags, rng):
    import cv2

    h, w = 96, 128
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(1.7, -2.3))
    ref = cv2.calcOpticalFlowFarneback(f0, f1, None, 0.5, 3, 15, 3, 5, 1.2, flags)
    params = FarnebackParams(gaussian_win=bool(flags & 256))
    mine = np.asarray(farneback_flow(jnp.asarray(f0), jnp.asarray(f1), params))
    err = _epe(ref, mine)
    # BASELINE target is < 0.1 px; we are at float-noise level.
    assert err.max() < 1e-3, err.max()
    assert err.mean() < 1e-4


def test_flow_small_image_level_clamp(rng):
    """Images too small for all levels: OpenCV clamps the pyramid."""
    import cv2

    h, w = 40, 48  # 0.125 scale would be < 32 px → fewer levels
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(0.8, 0.5))
    ref = cv2.calcOpticalFlowFarneback(f0, f1, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    mine = np.asarray(farneback_flow(jnp.asarray(f0), jnp.asarray(f1)))
    assert _epe(ref, mine).max() < 1e-3


def test_flow_batched_consistency(rng):
    f0 = _texture(64, 80, rng)
    f1 = _texture(64, 80, rng, shift=(1.0, 1.0))
    g0 = _texture(64, 80, rng, shift=(5.0, 0.0))
    g1 = _texture(64, 80, rng, shift=(6.5, -0.5))
    single_a = np.asarray(farneback_flow(jnp.asarray(f0), jnp.asarray(f1)))
    single_b = np.asarray(farneback_flow(jnp.asarray(g0), jnp.asarray(g1)))
    batched = np.asarray(
        farneback_flow(jnp.asarray(np.stack([f0, g0])), jnp.asarray(np.stack([f1, g1])))
    )
    np.testing.assert_allclose(batched[0], single_a, atol=1e-4)
    np.testing.assert_allclose(batched[1], single_b, atol=1e-4)


def test_poly_exp_is_weighted_lsq(rng):
    """Polynomial expansion == Gaussian-weighted LS quadratic fit."""
    n, sigma = 5, 1.2
    h, w = 32, 32
    img = rng.normal(size=(h, w)).astype(np.float64) * 20 + 100
    r = np.asarray(poly_exp(jnp.asarray(img[None], jnp.float32), n, sigma))[0]

    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2 * sigma * sigma))
    g /= g.sum()
    yy, xx = np.mgrid[-n : n + 1, -n : n + 1]
    wgt = (g[yy + n] * g[xx + n]).ravel()
    basis = np.stack(
        [np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy], axis=-1
    ).reshape(-1, 6).astype(np.float64)
    gram = basis.T @ (basis * wgt[:, None])

    for (py, px) in [(10, 12), (16, 16), (20, 8)]:
        patch = img[py - n : py + n + 1, px - n : px + n + 1].ravel()
        rhs = basis.T @ (patch * wgt)
        coef = np.linalg.solve(gram, rhs)  # [c, bx, by, axx, ayy, axy]
        np.testing.assert_allclose(r[py, px, 1], coef[1], rtol=2e-4, atol=2e-4)  # b_x
        np.testing.assert_allclose(r[py, px, 0], coef[2], rtol=2e-4, atol=2e-4)  # b_y
        np.testing.assert_allclose(r[py, px, 3], coef[3], rtol=2e-4, atol=2e-3)  # A_xx
        np.testing.assert_allclose(r[py, px, 2], coef[4], rtol=2e-4, atol=2e-3)  # A_yy
        np.testing.assert_allclose(r[py, px, 4], coef[5], rtol=2e-4, atol=2e-3)  # 2A_xy


def test_known_translation_epe(rng):
    """Absolute accuracy on a pure translation: EPE < 0.1 px in-ROI."""
    h, w = 96, 128
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(2.0, 1.0))
    mine = np.asarray(farneback_flow(jnp.asarray(f0), jnp.asarray(f1)))
    inner = mine[16:-16, 16:-16]
    epe = np.sqrt((inner[..., 0] + 2.0) ** 2 + (inner[..., 1] + 1.0) ** 2)
    # flow convention: sampling I1 at x+flow matches I0 motion -(2,1)...
    epe2 = np.sqrt((inner[..., 0] - 2.0) ** 2 + (inner[..., 1] - 1.0) ** 2)
    assert min(epe.mean(), epe2.mean()) < 0.1


class TestCvx:
    def test_bgr2gray_exact(self, rng):
        import cv2

        bgr = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        ref = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        mine = np.asarray(cvx.bgr2gray_u8(jnp.asarray(bgr)))
        np.testing.assert_array_equal(ref, mine)

    @pytest.mark.parametrize("out_hw", [(24, 32), (60, 80), (13, 17)])
    def test_resize_matches_cv2(self, out_hw, rng):
        import cv2

        img = rng.normal(size=(48, 64)).astype(np.float32)
        ref = cv2.resize(img, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
        mine = np.asarray(cvx.resize_bilinear(jnp.asarray(img), *out_hw))
        np.testing.assert_allclose(ref, mine, atol=1e-6)

    @pytest.mark.parametrize("k,s", [(3, 0.0), (19, 3.5), (7, 1.5), (9, 0.0)])
    def test_gaussian_blur_matches_cv2(self, k, s, rng):
        import cv2

        img = rng.normal(size=(48, 64)).astype(np.float32)
        ref = cv2.GaussianBlur(img, (k, k), s, sigmaY=s)
        mine = np.asarray(cvx.gaussian_blur_reflect101(jnp.asarray(img), k, s))
        np.testing.assert_allclose(ref, mine, atol=1e-5)

    def test_fill_poly_matches_cv2(self, rng):
        import cv2

        polys = [
            [(5, 5), (30, 8), (10, 30)],
            [(100, 100), (500, 120), (520, 380), (120, 400)],
        ]
        for i in range(25):
            k = rng.integers(3, 9)
            polys.append([tuple(v) for v in rng.integers(0, 60, size=(k, 2))])
        for i, poly in enumerate(polys):
            hw = (480, 640) if i == 1 else (64, 64)
            ref = np.zeros(hw, np.uint8)
            cv2.fillPoly(ref, [np.asarray(poly, np.int32)], 1)
            mine = cvx.fill_poly_mask(*hw, np.asarray(poly, float))
            assert np.array_equal(ref.astype(bool), mine), poly


def test_flow_use_initial_flow(rng):
    """OPTFLOW_USE_INITIAL_FLOW parity with cv2 (flags=4)."""
    import cv2

    h, w = 64, 80
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(1.0, -0.6))
    init = np.zeros((h, w, 2), np.float32)
    init[..., 0] = -1.0
    init[..., 1] = 0.5
    ref = cv2.calcOpticalFlowFarneback(
        f0, f1, init.copy(), 0.5, 3, 15, 3, 5, 1.2, cv2.OPTFLOW_USE_INITIAL_FLOW
    )
    params = FarnebackParams(use_initial_flow=True)
    mine = np.asarray(
        farneback_flow(jnp.asarray(f0), jnp.asarray(f1), params, flow0=jnp.asarray(init))
    )
    assert _epe(ref, mine).max() < 1e-3


def test_flow_multi_roi_features(rng):
    """Bilateral (multi-ROI) feature extraction (BASELINE config 2)."""
    from btcs_pnes_optical_flow.models.flow import roi_body_flow

    h, w = 64, 80
    f0 = _texture(h, w, rng)
    f1 = _texture(h, w, rng, shift=(1.0, 0.5))
    masks = np.zeros((2, h, w), bool)
    masks[0, 5:30, 5:38] = True   # "left"
    masks[1, 30:60, 40:75] = True  # "right"
    ex = jnp.asarray(np.array([[1.0, 0.0]], np.float32))
    ey = jnp.asarray(np.array([[0.0, 1.0]], np.float32))
    feats = roi_body_flow(jnp.asarray(f0)[None], jnp.asarray(f1)[None], ex, ey, jnp.asarray(masks))
    assert feats.vx.shape == (1, 2)
    # Cross-check each ROI against a manual masked mean of the flow.
    fl = np.asarray(farneback_flow(jnp.asarray(f0), jnp.asarray(f1)))
    for r in range(2):
        np.testing.assert_allclose(
            float(feats.vx[0, r]), fl[..., 0][masks[r]].mean(), rtol=1e-4, atol=1e-5
        )


def test_roi_reduction_matches_float64_mean(rng):
    """The ROI reduction (HIGHEST-precision einsum) equals a float64
    NumPy masked mean of the body-axis projections."""
    from btcs_pnes_optical_flow.models.flow import _project_reduce

    b, h, w = 3, 40, 56
    flow = rng.normal(0, 3, (b, h, w, 2)).astype(np.float32) + 100.0
    theta = rng.uniform(0, np.pi, b)
    ex = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    ey = np.stack([-np.sin(theta), np.cos(theta)], -1).astype(np.float32)
    masks = np.zeros((2, h, w), bool)
    masks[0, 5:30, 3:40] = True
    masks[1, ::3, ::2] = True
    got = _project_reduce(jnp.asarray(flow), jnp.asarray(ex), jnp.asarray(ey), jnp.asarray(masks))
    f64 = flow.astype(np.float64)
    fx = f64[..., 0] * ex[:, 0, None, None] + f64[..., 1] * ex[:, 1, None, None]
    fy = f64[..., 0] * ey[:, 0, None, None] + f64[..., 1] * ey[:, 1, None, None]
    for r in range(2):
        np.testing.assert_allclose(np.asarray(got.vx)[:, r], fx[:, masks[r]].mean(1), rtol=2e-6)
        np.testing.assert_allclose(np.asarray(got.vy)[:, r], fy[:, masks[r]].mean(1), rtol=2e-6)
        np.testing.assert_allclose(
            np.asarray(got.mag)[:, r], np.hypot(fx, fy)[:, masks[r]].mean(1), rtol=2e-6
        )


def test_flow_seq_matches_pairwise(rng):
    """farneback_flow_seq over an (N+1)-frame sequence equals
    farneback_flow on each consecutive pair."""
    from btcs_pnes_optical_flow.ops.farneback import farneback_flow_seq

    frames = np.stack([_texture(48, 64, rng, shift=(0.7 * i, -0.4 * i)) for i in range(4)])
    seq = np.asarray(farneback_flow_seq(jnp.asarray(frames)))
    assert seq.shape == (3, 48, 64, 2)
    for i in range(3):
        pair = np.asarray(farneback_flow(jnp.asarray(frames[i]), jnp.asarray(frames[i + 1])))
        np.testing.assert_allclose(seq[i], pair, atol=1e-5)
