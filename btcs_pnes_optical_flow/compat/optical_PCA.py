"""Drop-in equivalent of the reference's optical_PCA.py entry point.

Same public surface (butter_bandpass_sos, sos_required_padlen,
finite_runs, bandpass_nanrobust, align_axis_to_ref,
dynamic_pc1_sliding, main — optical_PCA.py:64-270), backed by the JAX
ops.  Parameters default to the reference constants
(optical_PCA.py:47-58).

Usage:  python -m btcs_pnes_optical_flow.compat.optical_PCA \
            [flow.csv] [flow_pc1.csv]
"""

from __future__ import annotations

import sys

import numpy as np

from btcs_pnes_optical_flow.config import PCAParams
from btcs_pnes_optical_flow.dataio import contracts
from btcs_pnes_optical_flow.models.pc1 import pc1_from_flow
from btcs_pnes_optical_flow.ops import design
from btcs_pnes_optical_flow.ops import filters as _filters
from btcs_pnes_optical_flow.ops import pca as _pca

FLOW_CSV = "flow.csv"
OUT_CSV = "flow_pc1.csv"

fs = 30
BPF_LOW_HZ = 0.5
BPF_HIGH_HZ = 5.0
BPF_ORDER = 4
WIN_SEC = 2.0
STEP_SEC = 0.1
MIN_SAMPLES_PCA = 3


def butter_bandpass_sos(low_hz, high_hz, fs, order=4):
    """Native Butterworth band-pass design (scipy-equivalent SOS)."""
    return design.butter_bandpass_sos(low_hz, high_hz, fs, order)


def sos_required_padlen(sos):
    return design.sos_required_padlen(sos)


def finite_runs(mask):
    """Contiguous True runs as inclusive (start, end) tuples."""
    idx = np.flatnonzero(np.asarray(mask))
    if idx.size == 0:
        return []
    gap = np.where(np.diff(idx) > 1)[0]
    starts = np.r_[idx[0], idx[gap + 1]]
    ends = np.r_[idx[gap], idx[-1]]
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def bandpass_nanrobust(x, sos):
    """NaN-robust zero-phase band-pass (scan-based sosfiltfilt)."""
    import jax.numpy as jnp

    zi = design.sosfilt_zi(sos).astype(np.float32)
    padreq = design.sos_required_padlen(sos)
    y = _filters.bandpass_nanrobust(
        jnp.asarray(np.asarray(x, np.float64), jnp.float32), sos, jnp.asarray(zi), padreq
    )
    return np.asarray(y, dtype=float)


def align_axis_to_ref(w, ref=np.array([0.0, 1.0])):
    """Sign-resolve an eigenvector against a reference direction."""
    w = np.asarray(w, float)
    if np.any(~np.isfinite(w)):
        return w
    return -w if float(np.dot(w, ref)) < 0 else w


def dynamic_pc1_sliding(time_sec, vx, vy, win_sec, step_sec, ref=np.array([0.0, 1.0])):
    """Sliding-window PCA → pc1_dyn (vectorized implementation)."""
    import jax.numpy as jnp

    win_n = max(MIN_SAMPLES_PCA, int(round(win_sec * fs)))
    step_n = max(1, int(round(step_sec * fs)))
    out = _pca.dynamic_pc1_sliding(
        jnp.asarray(np.asarray(vx, float), jnp.float32),
        jnp.asarray(np.asarray(vy, float), jnp.float32),
        win_n,
        step_n,
        MIN_SAMPLES_PCA,
        tuple(np.asarray(ref, float)),
    )
    return np.asarray(out, dtype=float)


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    flow_csv = argv[0] if len(argv) > 0 else FLOW_CSV
    out_csv = argv[1] if len(argv) > 1 else OUT_CSV

    cols = contracts.read_flow_csv(flow_csv)
    t = cols["t_sec"]
    vx = cols["vx_body"]
    vy = cols["vy_body"]

    import jax.numpy as jnp

    params = PCAParams(
        fs=fs, bpf_low_hz=BPF_LOW_HZ, bpf_high_hz=BPF_HIGH_HZ, bpf_order=BPF_ORDER,
        win_sec=WIN_SEC, step_sec=STEP_SEC, min_samples_pca=MIN_SAMPLES_PCA,
    )
    pc1 = np.asarray(
        pc1_from_flow(jnp.asarray(vx, jnp.float32), jnp.asarray(vy, jnp.float32), params)
    )
    contracts.write_csv(out_csv, contracts.pc1_columns(t, pc1))


if __name__ == "__main__":
    main()
