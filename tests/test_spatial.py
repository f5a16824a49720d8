"""Height-sharded full Farnebäck vs the unsharded exact path.

Equality on a multi-device CPU mesh validates the halo-exchange
decomposition (parallel/spatial.py); the same code runs unchanged on a
mesh of GPUs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from btcs_pnes_optical_flow.config import FarnebackParams
from btcs_pnes_optical_flow.ops.farneback import farneback_flow
from btcs_pnes_optical_flow.parallel.mesh import make_mesh
from btcs_pnes_optical_flow.parallel.spatial import farneback_flow_sharded


def _pair(rng, h, w, shift=(1.7, -2.3)):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(sh):
        x2, y2 = xx + sh[0], yy + sh[1]
        img = (np.sin(x2 / 7) * np.cos(y2 / 9) + 0.5 * np.sin(x2 / 3 + y2 / 5)) * 60 + 128
        return np.clip(img + rng.normal(0, 1, (h, w)), 0, 255).astype(np.uint8)

    return tex((0, 0)), tex(shift)


@pytest.mark.parametrize(
    "n_dev,h,w,params",
    [
        # Two-level pyramid, every level height-sharded on 4 devices.
        (4, 128, 96, FarnebackParams(levels=1, winsize=7)),
        # Default reference params; 192x256 → levels 0..2 all sharded.
        (4, 192, 256, FarnebackParams()),
        # winsize=15 with thin shards: level 1 (h_loc=6 < 7) runs via the
        # gather-replicated coarse path, level 0 sharded.
        (8, 96, 64, FarnebackParams(levels=1)),
    ],
)
def test_sharded_matches_unsharded(rng, n_dev, h, w, params):
    mesh = make_mesh(n_dev, axes=("spatial",))
    prev, curr = _pair(rng, h, w)
    prev = np.stack([prev, np.roll(curr, 3, axis=1)])
    curr = np.stack([curr, np.roll(prev[0], -2, axis=0)])

    ref = np.asarray(farneback_flow(jnp.asarray(prev), jnp.asarray(curr), params))
    out = np.asarray(farneback_flow_sharded(prev, curr, params, mesh))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_sharded_requires_divisible_height(rng):
    mesh = make_mesh(4, axes=("spatial",))
    prev, curr = _pair(rng, 100, 64)
    with pytest.raises(ValueError, match="must be divisible"):
        farneback_flow_sharded(
            prev[None], curr[None], FarnebackParams(levels=1), mesh
        )


def test_sharded_output_sharding(rng):
    mesh = make_mesh(4, axes=("spatial",))
    prev, curr = _pair(rng, 128, 64)
    out = farneback_flow_sharded(
        prev[None], curr[None], FarnebackParams(levels=1, winsize=7), mesh
    )
    assert len(out.sharding.device_set) == 4
