"""Frozen, hashable configuration tree.

The reference keeps every parameter as a module-level constant
(`optical_flow.py:48-56`, `optical_PCA.py:47-58`, `optical_PC1.py:33-44`).
Here they become frozen dataclasses whose defaults are *exactly* those
constants, so a default-constructed config reproduces the reference
pipeline bit-for-bit.  Configs are hashable and therefore usable as
static arguments to ``jax.jit`` — each distinct config specializes its
own compiled program (static shapes, static filter taps, static window
lengths).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_half_even(x: float) -> int:
    """Banker's rounding, matching Python round(), np.round and cvRound."""
    import math

    f = math.floor(x)
    diff = x - f
    if diff > 0.5:
        return f + 1
    if diff < 0.5:
        return f
    return f + 1 if f % 2 else f


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Dense Farnebäck optical-flow parameters.

    Defaults match the reference `FB_PARAMS` (optical_flow.py:48-56).
    ``gaussian_win`` corresponds to OpenCV's OPTFLOW_FARNEBACK_GAUSSIAN
    flag bit (flags=0 in the reference → box averaging).
    """

    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    gaussian_win: bool = False  # flags & OPTFLOW_FARNEBACK_GAUSSIAN
    use_initial_flow: bool = False  # flags & OPTFLOW_USE_INITIAL_FLOW
    # Per-level iteration schedule, indexed by pyramid level k (0 =
    # finest/full resolution); levels past the tuple's end reuse its
    # last entry.  None = ``iterations`` at every level (the reference
    # semantics, optical_flow.py:48-56 via cv2's `iterations`).
    # Coarse-level iterations only refine the *initial* flow handed to
    # finer levels, so trimming them trades an EPE-gated accuracy
    # epsilon for throughput.  Opt-in; the library default keeps the
    # exact schedule.
    iter_schedule: Optional[Tuple[int, ...]] = None

    def iters_at(self, k: int) -> int:
        """Iteration count at pyramid level k (0 = finest)."""
        if not self.iter_schedule:
            return self.iterations
        return self.iter_schedule[min(k, len(self.iter_schedule) - 1)]

    def num_levels(self, height: int, width: int, min_size: int = 32) -> int:
        """Number of *extra* pyramid levels actually used.

        OpenCV clamps `levels` so that every level is at least
        ``min_size`` pixels on each side; processing then runs from
        level ``k`` (coarsest) down to 0 (full resolution), i.e.
        ``num_levels + 1`` passes in total.
        """
        k = 0
        scale = 1.0
        while k < self.levels:
            scale *= self.pyr_scale
            if width * scale < min_size or height * scale < min_size:
                break
            k += 1
        return k

    def level_size(self, height: int, width: int, k: int) -> Tuple[int, int]:
        scale = self.pyr_scale**k
        return (_round_half_even(height * scale), _round_half_even(width * scale))


@dataclasses.dataclass(frozen=True)
class PCAParams:
    """Band-pass + sliding-window PCA parameters (optical_PCA.py:47-58).

    Note the reference hardcodes ``fs = 30`` and uses it for window
    sizing regardless of the true frame timestamps — we reproduce that.
    """

    fs: float = 30.0
    bpf_low_hz: float = 0.5
    bpf_high_hz: float = 5.0
    bpf_order: int = 4
    win_sec: float = 2.0
    step_sec: float = 0.1
    min_samples_pca: int = 3
    # Static bound on the number of contiguous finite runs the NaN-robust
    # band-pass will process (masked fixed-shape formulation; extra run
    # slots are no-ops).  Purely a compile-time capacity knob.
    max_finite_runs: int = 64

    @property
    def win_n(self) -> int:
        return max(self.min_samples_pca, _round_half_even(self.win_sec * self.fs))

    @property
    def step_n(self) -> int:
        return max(1, _round_half_even(self.step_sec * self.fs))


@dataclasses.dataclass(frozen=True)
class MetricParams:
    """PC1 metric-extraction parameters (optical_PC1.py:33-44)."""

    window_sec: float = 10.0
    smooth_sec: float = 0.20
    p95_win_sec: float = 2.0
    peak_min_frac: float = 0.20
    peak_min_abs: float = 0.0
    min_dist_sec: float = 0.2
    min_valid_samples: int = 10
    min_intervals_for_tau: int = 5


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration."""

    flow: FarnebackParams = FarnebackParams()
    pca: PCAParams = PCAParams()
    metrics: MetricParams = MetricParams()
