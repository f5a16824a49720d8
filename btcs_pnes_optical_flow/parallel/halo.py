"""Halo-exchange spatial sharding for windowed stencils.

The Farnebäck hot loop is separable stencils (poly-expansion taps,
winsize box sums).  When a single frame is too large for one chip — or
to cut latency on huge frames — the image height is sharded across a
mesh axis and each chip exchanges a `halo` of boundary rows with its
neighbors (`lax.ppermute`), then runs the stencil locally.
Boundary shards replicate their own edge rows, reproducing the
clamp-to-edge border of the unsharded op exactly.

This is the vision-stencil analogue of tensor/sequence parallelism:
communication is O(halo · W) per step while compute is O(H_local · W).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from btcs_pnes_optical_flow.ops import cvx


def exchange_rows(
    x: jnp.ndarray, halo: int, axis_name: str, border: str = "replicate"
) -> jnp.ndarray:
    """Concatenate neighbor halos along the (local) height axis.

    x: (..., H_loc, W).  Returns (..., H_loc + 2*halo, W) where the
    first/last `halo` rows come from the previous/next shard, or are
    border-filled on the boundary shards: ``border="replicate"``
    duplicates the edge row (clamp semantics), ``border="reflect101"``
    mirrors without duplicating the edge (cv2.GaussianBlur default).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    top_rows = x[..., :halo, :]
    bot_rows = x[..., -halo:, :]

    if n > 1:
        # Receive the *bottom* rows of the previous shard (above us).
        from_above = jax.lax.ppermute(
            bot_rows, axis_name, perm=[(i, i + 1) for i in range(n - 1)]
        )
        # Receive the *top* rows of the next shard (below us).
        from_below = jax.lax.ppermute(
            top_rows, axis_name, perm=[(i + 1, i) for i in range(n - 1)]
        )
    else:
        from_above = bot_rows
        from_below = top_rows

    if border == "replicate":
        edge_top = jnp.repeat(x[..., :1, :], halo, axis=-2)
        edge_bot = jnp.repeat(x[..., -1:, :], halo, axis=-2)
    elif border == "reflect101":
        edge_top = jnp.flip(x[..., 1 : halo + 1, :], axis=-2)
        edge_bot = jnp.flip(x[..., -halo - 1 : -1, :], axis=-2)
    else:  # pragma: no cover
        raise ValueError(f"unknown border {border!r}")
    top_halo = jnp.where(idx == 0, edge_top, from_above)
    bot_halo = jnp.where(idx == n - 1, edge_bot, from_below)
    return jnp.concatenate([top_halo, x, bot_halo], axis=-2)


_exchange_rows = exchange_rows  # back-compat alias


def sep_corr_replicate_sharded(
    x: jnp.ndarray,
    kv: np.ndarray,
    kh: np.ndarray,
    mesh: Mesh,
    axis_name: str = "spatial",
):
    """Height-sharded separable correlation with replicate border.

    Result equals ``cvx.sep_corr_replicate(x, kv, kh)`` with x sharded
    on its height axis over ``axis_name``.  Requires the local shard
    height >= len(kv)//2.
    """
    halo = len(kv) // 2

    def local(block):
        ext = _exchange_rows(block, halo, axis_name)
        ext = cvx.pad_replicate(ext, 0, len(kh) // 2)
        v = cvx.corr1d(ext, kv, axis=-2)
        return cvx.corr1d(v, kh, axis=-1)

    ndim = x.ndim
    spec_in = P(*([None] * (ndim - 2)), axis_name, None)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(spec_in,), out_specs=spec_in, check_vma=False
    )
    return fn(x)


def box_sum_replicate_sharded(
    x: jnp.ndarray, size: int, mesh: Mesh, axis_name: str = "spatial"
):
    """Height-sharded winsize box sum (the Farnebäck M-averaging)."""
    ones = np.ones(size, dtype=np.float64)
    return sep_corr_replicate_sharded(x, ones, ones, mesh, axis_name)
