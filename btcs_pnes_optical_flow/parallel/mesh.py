"""Device mesh construction and sharding helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    platform: Optional[str] = None,
) -> Mesh:
    """Build a mesh over the first n devices.

    Default is a 1-D 'data' mesh (cohort axis).  Pass
    axes=("data", "spatial") with a shape like (4, 2) for combined
    cohort × spatial-stencil sharding.  Devices come from ``platform``
    (default: JAX's default platform); asking for more devices than it
    has is an error, never a silent move to another platform.
    """
    devs = jax.devices(platform) if platform else jax.devices()
    if n_devices and len(devs) < n_devices:
        raise ValueError(
            f"make_mesh: asked for {n_devices} devices, but platform "
            f"{devs[0].platform!r} has {len(devs)}"
        )
    n = n_devices or len(devs)
    devs = devs[:n]
    if shape is None:
        shape = (n,) if len(axes) == 1 else (n // 2, 2)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axes)


def cohort_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> NamedSharding:
    """Shard the leading (video/cohort) axis; replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
