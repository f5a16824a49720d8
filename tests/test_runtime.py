"""Runtime plumbing: compile-cache placement, mesh construction, the
trace reduction and the GPU smoke script's refusal and helpers."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from btcs_pnes_optical_flow.parallel.mesh import make_mesh
from btcs_pnes_optical_flow.utils.compile_cache import DEFAULT_DIR, enable_compile_cache
from btcs_pnes_optical_flow.utils.timing import FLOW_SCOPES, busy_ns, scope_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "default"])
def test_compile_cache_placement(from_env, tmp_path, monkeypatch):
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = DEFAULT_DIR
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


def test_make_mesh_raises_when_short_of_devices():
    n = len(jax.devices())
    assert make_mesh(n).size == n
    with pytest.raises(ValueError, match=f"asked for {n + 1} devices"):
        make_mesh(n + 1)


def test_scope_of_picks_innermost_path_segment():
    name = "jit(roi_body_flow_seq)/jit(main)/jit(farneback_flow)/update_flow/conv_general_dilated"
    assert scope_of("fusion.12 " + name, FLOW_SCOPES) == "update_flow"
    assert scope_of("a/resize_flow/jit(resize_bilinear)/gather", FLOW_SCOPES) == "resize_flow"
    assert scope_of("a/poly_exp/b/update_matrices/c", FLOW_SCOPES) == "update_matrices"
    assert scope_of("copy.3 jit(main)/transpose", FLOW_SCOPES) == "other"
    assert scope_of("x/poly_exp_like/y", FLOW_SCOPES) == "other"


def test_busy_ns_is_the_union_of_intervals():
    assert busy_ns([]) == 0
    assert busy_ns([(0, 10), (5, 15), (20, 25), (21, 22), (30, 30)]) == 20
    assert busy_ns([(20, 25), (0, 10)]) == 15


@pytest.mark.parametrize("where", ["cpu", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """No GPU (or no repository beside the script): non-zero exit and
    no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_epe_stats():
    a = np.zeros((2, 4, 5, 2), np.float32)
    b = a.copy()
    b[1, 2, 3] = (3.0, 4.0)   # EPE 5 inside the mask
    b[0, 0, 0] = (30.0, 0.0)  # outside the mask: ignored
    mask = np.zeros((4, 5), bool)
    mask[1:3, 1:5] = True
    e_max, e_mean = chip_smoke.epe_stats(a, b, mask)
    assert e_max == 5.0
    assert e_mean == pytest.approx(5.0 / (2 * mask.sum()))


def test_chip_smoke_oracle_compare(rng):
    import jax.numpy as jnp

    from btcs_pnes_optical_flow.models.metrics import pc1_metrics
    from btcs_pnes_optical_flow.models.pc1 import pc1_from_flow

    n = 450
    t = np.arange(n) / 30.0
    phase = 2 * np.pi * (3.0 * t - 0.03 * t * t)
    amp = 2.0 * np.exp(-0.05 * t)
    vx = amp * np.sin(phase) * np.cos(0.4) + 0.05 * rng.normal(size=n)
    vy = amp * np.sin(phase) * np.sin(0.4) + 0.05 * rng.normal(size=n)
    vx[0] = vy[0] = np.nan
    vx[200:204] = vy[200:204] = np.nan
    pc1 = np.asarray(pc1_from_flow(jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32)),
                     np.float64)
    mets = pc1_metrics(t, pc1)
    corr, same_nan, pairs = chip_smoke.oracle_compare(t, vx, vy, pc1, mets)
    assert same_nan and corr > 0.999
    ours, ref = pairs["PC1_area_0_10"]
    assert abs(ours - ref) <= chip_smoke.AUC_REL_TOL * abs(ref)
    assert pairs["Peak_n"][0] == pairs["Peak_n"][1]


def test_chip_smoke_recording_geometry():
    """The smoke's ROI covers 10-15% of a 640x480 frame, and the limb it
    tracks moves inside it."""
    from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask

    mask = fill_poly_mask(chip_smoke.H, chip_smoke.W, chip_smoke.roi_polygon())
    assert 0.10 <= mask.mean() <= 0.15
    frames = chip_smoke.render_recording(0, 6, 96, 128)
    small = fill_poly_mask(96, 128, chip_smoke.roi_polygon(96, 128))
    moved = np.abs(np.diff(frames.astype(int), axis=0)).sum(0) > 0
    assert frames.shape == (6, 96, 128) and moved.any()
    assert moved[small].mean() > 10 * moved[~small].mean()
