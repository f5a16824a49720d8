"""Checks that need a GPU: the same jitted programs on the GPU and on
JAX's CPU backend.  They skip where JAX finds no GPU; run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``."""

import numpy as np
import pytest

import jax

from btcs_pnes_optical_flow.models.flow import roi_body_flow
from btcs_pnes_optical_flow.ops.farneback import farneback_flow


def _texture(h, w, rng, shift=(0.0, 0.0)):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xx, yy = xx + shift[0], yy + shift[1]
    img = (np.sin(xx / 7) * np.cos(yy / 9) + 0.5 * np.sin(xx / 3 + yy / 5)) * 60 + 128
    return np.clip(img + rng.normal(0, 1, (h, w)), 0, 255).astype(np.uint8)


def _epe(a, b):
    return np.sqrt(((a - b) ** 2).sum(-1))


def _both(fn, gpu, *args):
    cpu = jax.devices("cpu")[0]
    on = lambda d: fn(*[jax.device_put(a, d) for a in args])  # noqa: E731
    return on(gpu), on(cpu)


@pytest.mark.gpu
def test_flow_gpu_matches_cpu_backend(gpu, rng):
    f0 = np.stack([_texture(96, 128, rng), _texture(96, 128, rng, shift=(3.0, 1.0))])
    f1 = np.stack([_texture(96, 128, rng, shift=(1.7, -2.3)), _texture(96, 128, rng)])
    g, c = _both(farneback_flow, gpu, f0, f1)
    assert g.devices() == {gpu}
    assert _epe(np.asarray(g), np.asarray(c)).max() < 1e-3


@pytest.mark.gpu
def test_roi_means_gpu_match_cpu_backend(gpu, rng):
    """ROI means carry no TF32 error (the reduction pins HIGHEST)."""
    h, w = 96, 128
    f0 = _texture(h, w, rng)[None]
    f1 = _texture(h, w, rng, shift=(1.0, 0.5))[None]
    ex = np.array([[0.6, 0.8]], np.float32)
    ey = np.array([[-0.8, 0.6]], np.float32)
    masks = np.zeros((2, h, w), bool)
    masks[0, 10:60, 10:70] = True
    masks[1, 40:90, 60:120] = True
    g, c = _both(roi_body_flow, gpu, f0, f1, ex, ey, masks)
    for a, b in zip(g, c):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
