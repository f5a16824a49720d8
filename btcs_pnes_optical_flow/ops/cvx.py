"""OpenCV-exact image primitives in XLA.

Replacements for the OpenCV C++ image ops the reference
calls (SURVEY.md §2.3 N3, N5, and the resize/GaussianBlur internals of
N1's pyramid): semantics match OpenCV's documented/observed behavior so
the Farnebäck stack can hit the <0.1 px EPE target.

All functions are batched over a leading batch dimension and jittable;
kernels/coefficient tables are computed host-side in float64 at trace
time.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _round_half_even(x: float) -> int:
    f = math.floor(x)
    d = x - f
    if d > 0.5:
        return f + 1
    if d < 0.5:
        return f
    return f + 1 if f % 2 else f


def bgr2gray_u8(bgr: jnp.ndarray) -> jnp.ndarray:
    """BGR uint8 → gray uint8, OpenCV fixed-point arithmetic.

    cv2.cvtColor(COLOR_BGR2GRAY) uses BT.601 weights in 15-bit fixed
    point: y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15 (verified
    pixel-exact against OpenCV by exhaustive differential search).
    """
    b = bgr[..., 0].astype(jnp.int32)
    g = bgr[..., 1].astype(jnp.int32)
    r = bgr[..., 2].astype(jnp.int32)
    y = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
    return y.astype(jnp.uint8)


def bgr2gray_u8_np(bgr: np.ndarray) -> np.ndarray:
    """Host-NumPy twin of bgr2gray_u8 (identical integer math).

    Used on the decode path, so conversion stays on the host thread
    that decodes instead of costing a device dispatch per frame.
    """
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    y = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
    return y.astype(np.uint8)


def magnitude(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Elementwise sqrt(x² + y²) (cv2.magnitude, N5)."""
    return jnp.sqrt(x * x + y * y)


def pad_replicate(img: jnp.ndarray, py: int, px: int) -> jnp.ndarray:
    """Edge-replicate (BORDER_REPLICATE / clamp) padding, last two dims."""
    pads = [(0, 0)] * (img.ndim - 2) + [(py, py), (px, px)]
    return jnp.pad(img, pads, mode="edge")


def pad_reflect101(img: jnp.ndarray, py: int, px: int) -> jnp.ndarray:
    """BORDER_REFLECT_101 padding (edge pixel not duplicated)."""
    pads = [(0, 0)] * (img.ndim - 2) + [(py, py), (px, px)]
    return jnp.pad(img, pads, mode="reflect")


def corr1d(img: jnp.ndarray, kernel: np.ndarray, axis: int) -> jnp.ndarray:
    """1-D correlation along `axis` (-1 or -2) of a pre-padded image.

    The kernel is a static host-side array.  Lowered to a single XLA
    convolution (XLA convs are cross-correlations — no kernel flip);
    one op per pass keeps the HLO small.  Output is 'VALID' (input
    must be padded by len(kernel)//2 on each side).
    """
    karr = np.asarray(kernel, dtype=np.float64)
    klen = len(karr)
    if klen == 1:
        return img * float(karr[0])
    axis = axis % img.ndim
    lead = img.shape[: img.ndim - 2]
    h, w = img.shape[-2], img.shape[-1]
    # Depthwise over the flattened batch: every plane is one channel
    # with the (H, W) dims minor.
    nb = int(np.prod(lead)) if lead else 1
    x = img.reshape((1, nb, h, w))
    if axis == img.ndim - 2:
        rhs = np.broadcast_to(karr.reshape(1, 1, klen, 1), (nb, 1, klen, 1))
    else:
        rhs = np.broadcast_to(karr.reshape(1, 1, 1, klen), (nb, 1, 1, klen))
    y = jax.lax.conv_general_dilated(
        x,
        jnp.asarray(rhs, img.dtype),
        window_strides=(1, 1),
        padding="VALID",
        feature_group_count=nb,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # Reduced-precision passes (TF32 on the GPU) would break the
        # <0.1 px differential-EPE contract; the stencils stay fp32.
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(lead + y.shape[-2:])


def sep_corr_replicate(img: jnp.ndarray, kv: np.ndarray, kh: np.ndarray) -> jnp.ndarray:
    """Separable correlation with replicate border (same-size output)."""
    py, px = len(kv) // 2, len(kh) // 2
    x = pad_replicate(img, py, px)
    x = corr1d(x, kv, axis=-2)
    x = corr1d(x, kh, axis=-1)
    return x


def box_sum_replicate(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """size×size box *sum* with clamp-to-edge border.

    Matches the accumulation in OpenCV's FarnebackUpdateFlow_Blur
    (winsize box over matM with replicated edges).
    """
    ones = np.ones(size, dtype=np.float64)
    return sep_corr_replicate(img, ones, ones)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel semantics (float64).

    sigma <= 0 → fixed small kernels for ksize ∈ {1,3,5,7}, else
    sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    small = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        9: [v / 256.0 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4)],
    }
    if sigma <= 0 and ksize in small:
        return np.asarray(small[ksize], dtype=np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64)
    x = i - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur_reflect101(img: jnp.ndarray, ksize: int, sigma: float) -> jnp.ndarray:
    """cv2.GaussianBlur with default BORDER_REFLECT_101 (separable)."""
    k = gaussian_kernel(ksize, sigma)
    p = ksize // 2
    x = pad_reflect101(img, p, p)
    x = corr1d(x, k, axis=-2)
    x = corr1d(x, k, axis=-1)
    return x


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """cv2.resize(..., INTER_LINEAR) for float images.

    Source coordinate: s = (d + 0.5)*scale - 0.5 with scale = in/out;
    taps clamped to the valid range (OpenCV clamps the second tap and
    zeroes the weight outside — equivalent to clamping for bilinear).
    Identity when sizes match.
    """
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return img

    def axis_coeffs(n_in: int, n_out: int):
        scale = n_in / n_out
        d = np.arange(n_out, dtype=np.float64)
        s = (d + 0.5) * scale - 0.5
        i0 = np.floor(s).astype(np.int64)
        frac = s - i0
        # OpenCV clamps: coordinates below 0 → pixel 0 with frac 0;
        # beyond n_in-1 → last pixel.
        frac = np.where(i0 < 0, 0.0, frac)
        i0 = np.clip(i0, 0, n_in - 1)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        return i0, i1, frac.astype(np.float32)

    y0, y1, fy = axis_coeffs(in_h, out_h)
    x0, x1, fx = axis_coeffs(in_w, out_w)

    fy = jnp.asarray(fy)[..., :, None]
    fx = jnp.asarray(fx)[None, :]
    top = img[..., y0, :]
    bot = img[..., y1, :]
    rows = top * (1.0 - fy) + bot * fy
    left = rows[..., :, x0]
    right = rows[..., :, x1]
    return left * (1.0 - fx) + right * fx


def _resize_axis_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) interpolation matrix with the same tap/weight
    law as resize_bilinear's axis_coeffs (cv2 INTER_LINEAR)."""
    scale = n_in / n_out
    d = np.arange(n_out, dtype=np.float64)
    s = (d + 0.5) * scale - 0.5
    i0 = np.floor(s).astype(np.int64)
    frac = s - i0
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    w = np.zeros((n_out, n_in), np.float32)
    np.add.at(w, (d.astype(np.int64), i0), (1.0 - frac).astype(np.float32))
    np.add.at(w, (d.astype(np.int64), i1), frac.astype(np.float32))
    return w


@functools.partial(jax.jit, static_argnames=("out_h", "out_w"))
def resize_bilinear_mm(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """resize_bilinear as two dense matmuls instead of gathers.

    Bilinear resize at static sizes is a linear map: out = Wy @ img @
    Wx^T with 2-nonzero rows.  Precision is pinned HIGHEST so the fp32
    result equals the gather formulation (each row reduces to
    w0*a + w1*b; the remaining terms are exact zeros).  NaN caveat: a
    NaN input pixel poisons its whole output row/column through 0*NaN
    — use only on finite planes (images and flow fields are finite by
    construction here).
    """
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return img
    out = img
    if in_h != out_h:
        wy = jnp.asarray(_resize_axis_matrix(in_h, out_h))
        out = jnp.einsum(
            "oh,...hw->...ow", wy, out, precision=jax.lax.Precision.HIGHEST
        )
    if in_w != out_w:
        wx = jnp.asarray(_resize_axis_matrix(in_w, out_w))
        out = jnp.einsum(
            "pw,...hw->...hp", wx, out, precision=jax.lax.Precision.HIGHEST
        )
    return out


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _line8_pixels(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """8-connected Bresenham matching cv2.line(..., LINE_8, thickness=1).

    Integer Bresenham with OpenCV's LineIterator semantics
    (leftToRight=True): the walk is canonicalized to ascending x, the
    longer axis is major, err starts at dmaj - 2*dmin, and the minor
    axis advances on strictly-negative err.  Verified pixel-exact
    against cv2.line on tie-heavy probes (half-integer crossings of
    both slope signs on both axes).
    """
    h, w = mask.shape
    dx = x1 - x0
    dy = y1 - y0
    if dx < 0:  # leftToRight canonicalization
        x0, y0 = x1, y1
        dx, dy = -dx, -dy
    sy = 1 if dy >= 0 else -1
    ady = abs(dy)

    if ady > dx:
        dmaj, dmin = ady, dx
        xmaj = False
    else:
        dmaj, dmin = dx, ady
        xmaj = True

    err = dmaj - 2 * dmin
    x, y = x0, y0
    for _ in range(dmaj + 1):
        if 0 <= y < h and 0 <= x < w:
            mask[y, x] = True
        if err < 0:
            err += 2 * dmaj - 2 * dmin
            x += 1
            y += sy
        else:
            err -= 2 * dmin
            if xmaj:
                x += 1
            else:
                y += sy


def fill_poly_mask(height: int, width: int, polygon_xy: np.ndarray) -> np.ndarray:
    """Boolean ROI mask from a polygon (host-side NumPy).

    Replaces cv2.fillPoly for the reference's usage (optical_flow.py:
    88-107; vertices are cast to int32 first).  Reproduces OpenCV's
    two-part rasterization: (a) even-odd scanline fill between paired
    edge crossings, where each edge walks rows [y_top, y_bottom) in
    16.16 fixed point from its top vertex and a row's span is
    [ceil(x_left), floor(x_right)]; (b) the polygon outline drawn with
    the 8-connected Bresenham of cv2.line.  Differentially tested
    against cv2.fillPoly on convex/concave/random polygons.
    """
    poly = np.asarray(polygon_xy).astype(np.int32)  # truncation, as reference
    n = len(poly)
    mask = np.zeros((height, width), dtype=bool)
    if n == 0:
        return mask
    if n == 1:
        _line8_pixels(mask, poly[0, 0], poly[0, 1], poly[0, 0], poly[0, 1])
        return mask

    edges = []  # (y_top, y_bot, x_top_fp, dx_fp)
    for i in range(n):
        x0, y0 = int(poly[i, 0]), int(poly[i, 1])
        x1, y1 = int(poly[(i + 1) % n, 0]), int(poly[(i + 1) % n, 1])
        _line8_pixels(mask, x0, y0, x1, y1)
        if y0 == y1:
            continue
        if y0 < y1:
            yt, yb, xt = y0, y1, x0
            num = (x1 - x0) << _XY_SHIFT
        else:
            yt, yb, xt = y1, y0, x1
            num = (x0 - x1) << _XY_SHIFT
        dx_fp = int(num / (yb - yt))  # C-style truncation toward zero
        edges.append((yt, yb, xt << _XY_SHIFT, dx_fp))

    ymin = max(min(e[0] for e in edges), 0) if edges else 0
    ymax = min(max(e[1] for e in edges), height) if edges else 0
    for y in range(ymin, ymax):
        xs = []
        for yt, yb, x_fp, dx_fp in edges:
            if yt <= y < yb:
                xs.append(x_fp + (y - yt) * dx_fp)
        xs.sort()
        for j in range(0, len(xs) - 1, 2):
            lo = (xs[j] + _XY_ONE - 1) >> _XY_SHIFT
            hi = xs[j + 1] >> _XY_SHIFT
            lo = max(lo, 0)
            hi = min(hi, width - 1)
            if lo <= hi and 0 <= y < height:
                mask[y, lo : hi + 1] = True
    return mask
