"""Time-chunked PC1 for long recordings (sequence-chunked streaming).

A 10-minute 1080p recording is ~18k frames: the flow stage already
streams (chunked frame pairs with prefetch, models/pipeline.py); this
module chunks the *signal* stages so the whole pipeline runs in bounded
memory with one compiled program per chunk shape (SURVEY.md §5,
"long-context" row).

Chunking strategy (overlap-save):

- each chunk is processed with a margin M on both sides; only the
  interior [M, M+C) is kept;
- the zero-phase band-pass transient decays like |p|^n with the
  slowest pole |p| ≈ 0.966 (0.5 Hz edge at 30 fps), so M = 240 samples
  attenuates boundary effects to ~2e-4 relative;
- chunk starts are multiples of the PCA step so the sliding-window
  grid of every chunk coincides with the full-signal grid, making the
  windowed-PCA part exact on the kept interior;
- the per-window sign-stabilization chain is translation-invariant up
  to one global sign per chunk; the global sign is resolved against
  the previous chunk's kept output over the overlap region.
"""

from __future__ import annotations

import numpy as np

from btcs_pnes_optical_flow.config import PCAParams
from btcs_pnes_optical_flow.models.pc1 import pc1_from_flow


def pc1_streaming(
    vx: np.ndarray,
    vy: np.ndarray,
    params: PCAParams = PCAParams(),
    chunk_n: int = 4096,
    margin_n: int = 240,
    engine: str = "scan",
) -> np.ndarray:
    """Chunked dynamic-PC1 equal (to fp/transient tolerance) to the
    full-signal pc1_from_flow, in O(chunk) device memory."""
    import jax.numpy as jnp

    n = len(vx)
    if n <= chunk_n + 2 * margin_n:
        return np.asarray(
            pc1_from_flow(
                jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32), params, engine
            )
        )

    step = params.step_n
    # Align chunk boundaries to the sliding-window grid.
    chunk_n = (chunk_n // step) * step
    margin_n = max(((margin_n + step - 1) // step) * step, params.win_n)

    out = np.full(n, np.nan, dtype=np.float64)
    buf_len = chunk_n + 2 * margin_n
    prev_tail = None  # kept output of the previous chunk's last margin

    for s in range(0, n, chunk_n):
        lo = s - margin_n
        hi = s + chunk_n + margin_n
        # Static shape: pad with NaN beyond the signal (NaN samples are
        # ignored by every downstream op, matching absent data).
        seg_x = np.full(buf_len, np.nan, dtype=np.float64)
        seg_y = np.full(buf_len, np.nan, dtype=np.float64)
        a = max(lo, 0)
        b = min(hi, n)
        seg_x[a - lo : b - lo] = vx[a:b]
        seg_y[a - lo : b - lo] = vy[a:b]

        pc1 = np.asarray(
            pc1_from_flow(
                jnp.asarray(seg_x, jnp.float32),
                jnp.asarray(seg_y, jnp.float32),
                params,
                engine,
            ),
            dtype=np.float64,
        )

        # Resolve the chunk-global sign of the PCA axis chain against
        # the previous chunk over the shared margin.
        if prev_tail is not None:
            ov_mine = pc1[:margin_n]
            both = np.isfinite(ov_mine) & np.isfinite(prev_tail)
            if both.sum() >= 3:
                corr = float(np.dot(ov_mine[both], prev_tail[both]))
                if corr < 0:
                    pc1 = -pc1

        keep_lo = margin_n
        keep_hi = min(margin_n + chunk_n, margin_n + (n - s))
        out[s : s + (keep_hi - keep_lo)] = pc1[keep_lo:keep_hi]
        prev_tail = pc1[keep_hi - margin_n : keep_hi] if keep_hi - margin_n >= 0 else None
        # prev_tail corresponds to samples [s+C-M, s+C) == next chunk's
        # leading margin.

    return out
