"""Observability: stage timing, device profiling, structured logging.

The reference has no tracing/metrics at all (SURVEY.md §5); these are
the production-side additions: wall/device timers with proper
``block_until_ready`` fencing, jax.profiler trace capture, and
per-stage throughput logging (ROI-frames/sec, the BASELINE metric).
"""

from btcs_pnes_optical_flow.utils.timing import StageTimer, device_timer, trace  # noqa: F401
