"""Flow feature extraction: batched Farnebäck + body-axis ROI reduction.

Stage A of the pipeline (reference: compute_roi_mean_body_flow,
optical_flow.py:136-189, and the per-frame driver loop
optical_flow.py:222-250).  The reference processes one frame pair at a
time through OpenCV; here frame *pairs are the batch axis*: a chunk of
(prev, curr) pairs runs through one jitted program that computes dense
flow, projects onto per-frame body axes, and reduces over (possibly
several) ROI masks — no host round-trips inside a chunk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from btcs_pnes_optical_flow.config import FarnebackParams
from btcs_pnes_optical_flow.ops import cvx
from btcs_pnes_optical_flow.ops.farneback import farneback_flow, farneback_flow_seq


class FlowFeatures(NamedTuple):
    vx: jnp.ndarray   # (B, R) mean body-x velocity per ROI
    vy: jnp.ndarray   # (B, R)
    mag: jnp.ndarray  # (B, R)


@functools.partial(jax.jit, static_argnames=("params",))
def roi_body_flow(
    prev_gray: jnp.ndarray,
    gray: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    roi_masks: jnp.ndarray,
    params: FarnebackParams = FarnebackParams(),
) -> FlowFeatures:
    """Batched ROI-averaged body-axis flow features.

    prev_gray, gray: (B, H, W) uint8/float frame pairs.
    ex, ey: (B, 2) per-pair body-axis unit vectors (the axes of the
        *current* frame, optical_flow.py:232-234).
    roi_masks: (R, H, W) bool — R ROIs (e.g. bilateral left/right).

    Matches the reference reduction: project flow onto (ex, ey), take
    the plain mean over each ROI (flow is never NaN, so nanmean ≡ mean).
    """
    flow = farneback_flow(prev_gray, gray, params)
    return _project_reduce(flow, ex, ey, roi_masks)


def _project_reduce(flow, ex, ey, roi_masks) -> FlowFeatures:
    fx = flow[..., 0]
    fy = flow[..., 1]
    fx_body = fx * ex[:, 0, None, None] + fy * ex[:, 1, None, None]
    fy_body = fx * ey[:, 0, None, None] + fy * ey[:, 1, None, None]
    mag_body = cvx.magnitude(fx_body, fy_body)

    m = roi_masks.astype(fx.dtype)  # (R, H, W)
    cnt = jnp.maximum(jnp.sum(m, axis=(-2, -1)), 1.0)  # (R,)

    def red(z):
        # HIGHEST: a float32 matmul may otherwise run in TF32 on the GPU,
        # which keeps ~3 decimal digits of each flow value.
        s = jnp.einsum("bhw,rhw->br", z, m, precision=jax.lax.Precision.HIGHEST)
        return s / cnt[None, :]

    with jax.named_scope("roi_reduce"):
        return FlowFeatures(vx=red(fx_body), vy=red(fy_body), mag=red(mag_body))


@functools.partial(jax.jit, static_argnames=("params",))
def roi_body_flow_seq(
    frames: jnp.ndarray,
    ex: jnp.ndarray,
    ey: jnp.ndarray,
    roi_masks: jnp.ndarray,
    params: FarnebackParams = FarnebackParams(),
) -> FlowFeatures:
    """ROI features for the B consecutive pairs of (B+1, H, W) frames.

    The production entry point of the flow stage: one frame array per
    chunk, half the host→device traffic of the pair form.
    """
    flow = farneback_flow_seq(frames, params)
    return _project_reduce(flow, ex, ey, roi_masks)


def frame_times(
    pos_msec: Optional[np.ndarray], n_frames: int, fps: float
) -> np.ndarray:
    """Per-frame timestamps (host).

    Mirrors frame_time_sec (optical_flow.py:110-119): prefer the
    container timestamp when it is positive, else frame_idx/fps.
    """
    idx_t = np.arange(n_frames, dtype=np.float64) / float(fps)
    if pos_msec is None:
        return idx_t
    pm = np.asarray(pos_msec, dtype=np.float64)
    return np.where(pm > 0, pm / 1000.0, idx_t)


def skel_indices(t_sec: np.ndarray, time_all: np.ndarray) -> np.ndarray:
    """Causal timestamp → upstream-index map (optical_flow.py:122-133).

    Largest idx with time_all[idx] <= t, clipped to the valid range —
    vectorized over all frames at once.
    """
    idx = np.searchsorted(time_all, t_sec, side="right") - 1
    return np.clip(idx, 0, len(time_all) - 1).astype(np.int64)
