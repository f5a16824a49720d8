"""btcs_pnes_optical_flow — a JAX video-analytics framework.

A ground-up JAX/XLA re-design of the BTCS/PNES clonic-movement
quantification pipeline (reference: saitosatoshi-1/BTCS_PNES_optical_flow).
The reference is three sequential CPU scripts built on OpenCV/SciPy
(`optical_flow.py`, `optical_PCA.py`, `optical_PC1.py`); this framework
provides the same behavioral contract — dense Farnebäck optical flow
projected onto body axes, band-passed sliding-window PCA, and clinical
PC1 metrics (AUC / ADS / Kendall τ) — as batched, jit-compiled,
device-resident programs that shard across device meshes.

Layout
------
- ``ops``      Compute primitives (flow kernels, IIR filters, PCA,
               peak detection, rank statistics, OpenCV-exact image ops).
- ``models``   Pipeline stages composed from ops (flow extractor, PC1
               model, metrics head, fused end-to-end pipeline).
- ``parallel`` Mesh construction, cohort sharding, halo-exchange spatial
               sharding, time-chunked streaming.
- ``dataio``   Host-side video decode + prefetch, CSV/NPZ compatibility
               layer matching the reference file contracts.
- ``compat``   Drop-in entry points mirroring the reference scripts'
               public API (including the three functions the reference
               calls but never defines).
"""

__version__ = "0.1.0"

from btcs_pnes_optical_flow.config import (  # noqa: F401
    FarnebackParams,
    PCAParams,
    MetricParams,
    PipelineConfig,
)
