"""Differential tests: sliding-window PCA vs reference behavior (C14-C15)."""

import numpy as np
import pytest

import jax.numpy as jnp

from btcs_pnes_optical_flow.ops import pca
from tests.reference_impl import ref_dynamic_pc1


def _make_signal(n, rng, nan_spans=(), rot_period=200.0):
    """2-D velocity with a slowly rotating dominant axis + noise."""
    t = np.arange(n) / 30.0
    theta = 2 * np.pi * np.arange(n) / rot_period
    amp = np.sin(2 * np.pi * 3.0 * t) * (1.0 + 0.3 * np.cos(2 * np.pi * 0.2 * t))
    vx = amp * np.cos(theta) + 0.05 * rng.normal(size=n)
    vy = amp * np.sin(theta) + 0.05 * rng.normal(size=n)
    for s, e in nan_spans:
        vx[s:e] = np.nan
        vy[s:e] = np.nan
    return vx, vy


@pytest.mark.parametrize("nan_spans", [(), ((100, 130), (400, 405))])
def test_dynamic_pc1_matches_reference(nan_spans, rng):
    n = 600
    vx, vy = _make_signal(n, rng, nan_spans)
    ref = ref_dynamic_pc1(np.arange(n) / 30.0, vx, vy)
    mine = np.asarray(
        pca.dynamic_pc1_sliding(jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32), 60, 3)
    )
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    fin = np.isfinite(ref)
    # fp32 vs fp64 eigensolves: compare via near-equality.
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=2e-3, atol=2e-3)
    # Waveform correlation must exceed the BASELINE fidelity target.
    c = np.corrcoef(mine[fin], ref[fin])[0, 1]
    assert c > 0.9999


def test_dynamic_pc1_short_input():
    out = np.asarray(pca.dynamic_pc1_sliding(jnp.zeros(2), jnp.zeros(2), 60, 3))
    assert np.all(np.isnan(out))


def test_dynamic_pc1_no_valid_windows():
    n = 100
    vx = jnp.full((n,), jnp.nan)
    vy = jnp.full((n,), jnp.nan)
    out = np.asarray(pca.dynamic_pc1_sliding(vx, vy, 60, 3))
    assert np.all(np.isnan(out))


def test_dynamic_pc1_sparse_valid_windows(rng):
    """Only some windows have >= 3 finite samples; centers chain must skip."""
    n = 300
    vx, vy = _make_signal(n, rng)
    vx[0:150] = np.nan
    vy[0:150] = np.nan
    vx[155:160] = np.nan  # leaves short valid pockets inside some windows
    ref = ref_dynamic_pc1(np.arange(n) / 30.0, vx, vy)
    mine = np.asarray(
        pca.dynamic_pc1_sliding(jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32), 60, 3)
    )
    assert np.array_equal(np.isnan(mine), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mine[fin], ref[fin], rtol=2e-3, atol=2e-3)


def test_eigvec2x2_matches_numpy(rng):
    for _ in range(50):
        a = rng.normal(size=(2, 2))
        c = a @ a.T
        w_ref_vals, w_ref_vecs = np.linalg.eigh(c)
        w_ref = w_ref_vecs[:, np.argmax(w_ref_vals)]
        w = np.asarray(
            pca.eigvec2x2_major(
                jnp.asarray(c[0, 0], jnp.float32),
                jnp.asarray(c[0, 1], jnp.float32),
                jnp.asarray(c[1, 1], jnp.float32),
            )
        )
        # Same axis up to sign.
        dot = abs(float(w @ w_ref))
        assert dot > 1 - 1e-5


def test_eigvec2x2_zero_matrix():
    w = np.asarray(pca.eigvec2x2_major(jnp.float32(0), jnp.float32(0), jnp.float32(0)))
    assert np.allclose(np.abs(w), [1.0, 0.0])
