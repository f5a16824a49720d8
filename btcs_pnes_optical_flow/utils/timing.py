"""Timing and profiling utilities."""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import jax

logger = logging.getLogger("btcs_pnes_optical_flow")
# Production observability default: per-chunk progress / stage rates go
# to stderr unless the embedding application configures logging itself
# or opts out (BTCS_LOG_LEVEL=WARNING silences progress).
if not logger.handlers and not logging.getLogger().handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("BTCS_LOG_LEVEL", "INFO"))


@contextlib.contextmanager
def device_timer(name: str, sink: Optional[Dict[str, float]] = None):
    """Wall-time a block with device fencing on both edges.

    Without ``block_until_ready`` JAX's async dispatch makes wall times
    meaningless; this fences pending work before starting and forces
    the block's outputs via the returned `finish` handle.
    """
    holder = {}

    def finish(tree):
        holder["out"] = tree
        return tree

    t0 = time.perf_counter()
    yield finish
    if "out" in holder:
        jax.block_until_ready(holder["out"])
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    logger.debug("stage %s: %.4fs", name, dt)


class StageTimer:
    """Accumulates per-stage wall time and item counts; reports rates."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.items: Dict[str, int] = {}

    def timed(self, name: str, n_items: int = 0):
        self.items[name] = self.items.get(name, 0) + n_items
        return device_timer(name, self.times)

    def add_items(self, name: str, n: int):
        self.items[name] = self.items.get(name, 0) + n

    def rates(self) -> Dict[str, float]:
        return {
            k: (self.items.get(k, 0) / t if t > 0 else 0.0)
            for k, t in self.times.items()
        }

    def report(self) -> str:
        rows = {
            k: {
                "seconds": round(t, 4),
                "items": self.items.get(k, 0),
                "items_per_sec": round(self.items.get(k, 0) / t, 2) if t > 0 else None,
            }
            for k, t in self.times.items()
        }
        return json.dumps(rows)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace capture around a block (view with XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Named scopes of the flow chunk step (ops/farneback.py, models/flow.py).
FLOW_SCOPES = (
    "level_image", "poly_exp", "update_matrices", "update_flow", "resize_flow",
    "roi_reduce",
)


def scope_of(op_text: str, scopes: Sequence[str]) -> str:
    """The innermost of `scopes` that appears as a path segment of a
    device op's name stack (``.../poly_exp/conv...``), else "other"."""
    best, at = "other", -1
    for s in scopes:
        i = op_text.rfind("/" + s + "/")
        if i > at:
            best, at = s, i
    return best


def busy_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_time_by_scope(log_dir: str, scopes: Sequence[str]) -> dict:
    """Device time per named scope from the newest profiler trace in
    `log_dir`, read from the kernel events on the "Stream" lines of the
    first GPU plane.  Each kernel is attributed by :func:`scope_of` to
    its op's name stack (the ``name`` stat).  XLA names a fusion of ops
    from several scopes after their common prefix, so such kernels land
    in "other"; ``by_op`` keeps them apart by (scope, HLO kind).

    Returns by_scope and by_op (ns), busy_ns (union of the kernel
    intervals), window_ns (first start to last end) and n_events.  Run
    with ``--xla_gpu_enable_command_buffer=`` in XLA_FLAGS, or kernels
    that XLA groups into CUDA graphs show up as one opaque event each.
    """
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True))
    data = jax.profiler.ProfileData.from_file(paths[-1])
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise ValueError(f"no GPU plane in {paths[-1]}")
    by_scope = dict.fromkeys(list(scopes) + ["other"], 0)
    by_op: Dict[Tuple[str, str], int] = {}
    spans: List[Tuple[int, int]] = []
    for ln in planes[0].lines:
        if not ln.name.startswith("Stream"):
            continue
        for ev in ln.events:
            start, dur = int(ev.start_ns), int(ev.duration_ns)
            stats = dict(ev.stats)
            scope = scope_of(stats.get("name", ""), scopes)
            kind = stats.get("hlo_op", ev.name).split(".")[0]
            by_scope[scope] += dur
            by_op[scope, kind] = by_op.get((scope, kind), 0) + dur
            spans.append((start, start + dur))
    return {
        "by_scope": by_scope,
        "by_op": by_op,
        "busy_ns": busy_ns(spans),
        "window_ns": max(e for _, e in spans) - min(s for s, _ in spans),
        "n_events": len(spans),
    }
