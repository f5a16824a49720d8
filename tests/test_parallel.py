"""Multi-chip tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from btcs_pnes_optical_flow.config import FarnebackParams, PCAParams
from btcs_pnes_optical_flow.ops import cvx
from btcs_pnes_optical_flow.parallel import cohort, halo, mesh as mesh_lib


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 host devices"
    return mesh_lib.make_mesh(8, axes=("data",))


@pytest.fixture(scope="module")
def mesh_spatial():
    return mesh_lib.make_mesh(4, axes=("spatial",))


def test_halo_box_sum_matches_unsharded(mesh_spatial, rng):
    x = jnp.asarray(rng.normal(size=(2, 5, 64, 40)), jnp.float32)
    ref = np.asarray(cvx.box_sum_replicate(x, 15))
    xs = jax.device_put(x, NamedSharding(mesh_spatial, P(None, None, "spatial", None)))
    out = np.asarray(halo.box_sum_replicate_sharded(xs, 15, mesh_spatial))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_halo_sep_corr_matches_unsharded(mesh_spatial, rng):
    from btcs_pnes_optical_flow.ops.cvx import gaussian_kernel

    k = gaussian_kernel(11, 1.2)
    x = jnp.asarray(rng.normal(size=(3, 48, 56)), jnp.float32)
    ref = np.asarray(cvx.sep_corr_replicate(x, k, k))
    xs = jax.device_put(x, NamedSharding(mesh_spatial, P(None, "spatial", None)))
    out = np.asarray(halo.sep_corr_replicate_sharded(xs, k, k, mesh_spatial))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_cohort_step_sharded_matches_single(mesh8, rng):
    """8-video cohort sharded across 8 devices == unsharded result."""
    v, b, h, w = 8, 3, 40, 48
    prev = rng.integers(0, 255, (v, b, h, w)).astype(np.uint8)
    curr = np.clip(prev.astype(int) + rng.integers(-20, 20, prev.shape), 0, 255).astype(np.uint8)
    theta = rng.normal(size=(v, b))
    ex = np.stack([np.cos(theta), np.sin(theta)], axis=-1).astype(np.float32)
    ey = np.stack([-np.sin(theta), np.cos(theta)], axis=-1).astype(np.float32)
    masks = np.zeros((1, h, w), bool)
    masks[0, 8:32, 8:40] = True
    t_valid = np.ones((v, b), bool)

    params = FarnebackParams(levels=1, winsize=7, poly_n=5)
    pca = PCAParams(win_sec=0.1, step_sec=0.05, max_finite_runs=4)

    args = (jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(ex), jnp.asarray(ey),
            jnp.asarray(masks), jnp.asarray(t_valid))
    ref = cohort.cohort_step(*args, params, pca)

    sharded_args = cohort.shard_cohort_inputs(mesh8, *args)
    out = cohort.cohort_step(*sharded_args, params, pca)

    np.testing.assert_allclose(np.asarray(out.vx), np.asarray(ref.vx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.cohort_mean_mag), np.asarray(ref.cohort_mean_mag), rtol=1e-5)
    # The sharded run really is distributed over 8 devices.
    assert len(out.vx.sharding.device_set) == 8


def test_run_cohort_mesh_matches_sequential(mesh8, rng):
    """The PRODUCTION cohort runner on an 8-device mesh must equal the
    sequential path: same flow features, PC1, and metric rows."""
    from btcs_pnes_optical_flow.config import PipelineConfig
    from btcs_pnes_optical_flow.dataio import contracts
    from btcs_pnes_optical_flow.parallel.runner import CohortItem, run_cohort

    n_videos, n_frames, h, w = 8, 33, 48, 64
    roi = np.array([[6.0, 6.0], [58.0, 8.0], [56.0, 42.0], [8.0, 40.0]])
    yy, xx = np.mgrid[0:h, 0:w]
    items = []
    for v in range(n_videos):
        r = np.random.default_rng(100 + v)
        t = np.arange(n_frames) / 30.0
        cx = w * 0.5 + 8 * np.sin(2 * np.pi * 2.5 * t + v)
        tex = 20 * np.sin(xx / 4.7) * np.cos(yy / 5.3) + r.normal(0, 3, (h, w))
        clip = np.empty((n_frames, h, w), np.uint8)
        for i in range(n_frames):
            blob = 150 * np.exp(-(((xx - cx[i]) / 6.0) ** 2 + ((yy - h / 2) / 6.0) ** 2))
            clip[i] = np.clip(70 + tex + blob, 0, 255).astype(np.uint8)
        theta = 0.3 + 0.01 * v
        ex = np.tile(np.array([np.cos(theta), -np.sin(theta)]), (n_frames, 1))
        ey = np.tile(np.array([np.sin(theta), np.cos(theta)]), (n_frames, 1))
        if v == 3:  # invalid-axes window exercises the NaN masking
            ex = ex.copy(); ey = ey.copy()
            ex[10:13] = np.nan; ey[10:13] = np.nan
        skel = contracts.Skeleton(time_all=t, ex=ex, ey=ey, fps=30.0)
        items.append(CohortItem(name=f"v{v}", video=clip, skeleton=skel, roi_polygons=[roi]))

    cfg = PipelineConfig()
    df_seq = run_cohort(items, cfg, chunk_pairs=16)
    df_mesh = run_cohort(items, cfg, chunk_pairs=16, mesh=mesh8)
    assert df_seq.dtype.names == df_mesh.dtype.names
    for col in df_seq.dtype.names:
        a, b = df_seq[col], df_mesh[col]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9, equal_nan=True)
        else:
            np.testing.assert_array_equal(b, a)


def test_run_cohort_device_resident_clips(mesh8, rng):
    """Device-resident (jax.Array) cohort clips take the sharded path
    and produce the same rows as host ndarrays, so clips staged once
    upstream are first-class inputs."""
    from btcs_pnes_optical_flow.config import PipelineConfig
    from btcs_pnes_optical_flow.dataio import contracts
    from btcs_pnes_optical_flow.parallel.runner import CohortItem, run_cohort

    n_videos, n_frames, h, w = 4, 17, 48, 64
    roi = np.array([[6.0, 6.0], [58.0, 8.0], [56.0, 42.0], [8.0, 40.0]])
    yy, xx = np.mgrid[0:h, 0:w]

    def build(video_of):
        items = []
        for v in range(n_videos):
            r = np.random.default_rng(200 + v)
            t = np.arange(n_frames) / 30.0
            cx = w * 0.5 + 8 * np.sin(2 * np.pi * 2.5 * t + v)
            clip = np.empty((n_frames, h, w), np.uint8)
            tex = r.normal(0, 3, (h, w))
            for i in range(n_frames):
                blob = 150 * np.exp(-(((xx - cx[i]) / 6.0) ** 2 + ((yy - h / 2) / 6.0) ** 2))
                clip[i] = np.clip(70 + tex + blob, 0, 255).astype(np.uint8)
            theta = 0.3
            ex = np.tile(np.array([np.cos(theta), -np.sin(theta)]), (n_frames, 1))
            ey = np.tile(np.array([np.sin(theta), np.cos(theta)]), (n_frames, 1))
            skel = contracts.Skeleton(time_all=t, ex=ex, ey=ey, fps=30.0)
            items.append(CohortItem(
                name=f"v{v}", video=video_of(clip), skeleton=skel,
                roi_polygons=[roi],
            ))
        return items

    cfg = PipelineConfig()
    df_host = run_cohort(build(lambda c: c), cfg, chunk_pairs=8, mesh=mesh8)
    df_dev = run_cohort(build(jnp.asarray), cfg, chunk_pairs=8, mesh=mesh8)
    for col in df_host.dtype.names:
        a, b = df_host[col], df_dev[col]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9, equal_nan=True)
        else:
            np.testing.assert_array_equal(b, a)
