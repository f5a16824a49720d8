"""Dynamic-PC1 stage: band-pass + sliding-window PCA.

Behavioral clone of the reference's optical_PCA.py main() pipeline
(optical_PCA.py:241-270): NaN-robust zero-phase Butterworth band-pass
of the body-axis velocities, then sliding-window PCA projection.  One
jit-compiled program, vmappable over a cohort batch of recordings.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from btcs_pnes_optical_flow.config import PCAParams
from btcs_pnes_optical_flow.ops import filters, pca


@functools.partial(jax.jit, static_argnames=("params", "engine"))
def pc1_from_flow(
    vx: jnp.ndarray,
    vy: jnp.ndarray,
    params: PCAParams = PCAParams(),
    engine: str = "scan",
) -> jnp.ndarray:
    """(vx_body, vy_body) → pc1_dyn waveform.

    The filter is designed host-side at trace time (static SOS
    constants); windows use the reference's hardcoded fs
    (optical_PCA.py:50,174-175), not the timestamps.
    """
    sos, zi, padreq = filters.make_bandpass(
        params.bpf_low_hz, params.bpf_high_hz, params.fs, params.bpf_order
    )
    zi = jnp.asarray(zi, vx.dtype)
    vx_f = filters.bandpass_nanrobust(
        vx, sos, zi, padreq, max_runs=params.max_finite_runs, engine=engine
    )
    vy_f = filters.bandpass_nanrobust(
        vy, sos, zi, padreq, max_runs=params.max_finite_runs, engine=engine
    )
    return pca.dynamic_pc1_sliding(
        vx_f, vy_f, params.win_n, params.step_n, params.min_samples_pca
    )


def pc1_from_flow_batch(vx, vy, params: PCAParams = PCAParams(), engine: str = "scan"):
    """Cohort-batched variant: (B, N) velocities → (B, N) pc1."""
    fn = functools.partial(pc1_from_flow, params=params, engine=engine)
    return jax.vmap(fn)(vx, vy)
