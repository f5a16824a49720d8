"""Cohort-scale execution: many recordings sharded across a mesh.

BASELINE.json config 4: a cohort of seizure videos sharded across a
mesh, with per-video metric tables.  The cohort axis is pure data
parallelism: each device owns a slice of the videos, the per-video
pipeline (flow → PC1) is vmapped inside the shard, and cohort-level
reductions (summary statistics) become XLA all-reduces, which XLA hands
to NCCL between GPUs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from btcs_pnes_optical_flow.config import FarnebackParams, PCAParams
from btcs_pnes_optical_flow.models.flow import roi_body_flow, roi_body_flow_seq
from btcs_pnes_optical_flow.models.pc1 import pc1_from_flow


class CohortStep(NamedTuple):
    vx: jnp.ndarray      # (V, B, R)
    vy: jnp.ndarray
    mag: jnp.ndarray
    pc1: jnp.ndarray     # (V, R, B+1)
    cohort_mean_mag: jnp.ndarray  # (R,) — cohort all-reduce


@functools.partial(jax.jit, static_argnames=("flow_params", "pca_params"))
def cohort_step(
    prev: jnp.ndarray,   # (V, B, H, W) frame-pair batches per video
    curr: jnp.ndarray,
    ex: jnp.ndarray,     # (V, B, 2)
    ey: jnp.ndarray,
    masks: jnp.ndarray,  # (R, H, W)
    t_valid: jnp.ndarray,  # (V, B) bool — which pairs are live
    flow_params: FarnebackParams = FarnebackParams(),
    pca_params: PCAParams = PCAParams(),
) -> CohortStep:
    """One fused cohort step: flow features + dynamic PC1 per video.

    All inputs may be sharded on the leading (video) axis; everything
    below is batched code, so XLA partitions it without any manual
    collectives — except the cohort reduction at the end, which lowers
    to an all-reduce across the mesh.
    """

    def one_video(p, c, e1, e2, tv):
        feats = roi_body_flow(p, c, e1, e2, masks, flow_params)
        vx = jnp.where(tv[:, None], feats.vx, jnp.nan)
        vy = jnp.where(tv[:, None], feats.vy, jnp.nan)
        mag = jnp.where(tv[:, None], feats.mag, jnp.nan)
        # Frame 0 has no pair (reference semantics): prepend NaN.
        nan1 = jnp.full((1, vx.shape[1]), jnp.nan, vx.dtype)
        vx_t = jnp.concatenate([nan1, vx]).T  # (R, B+1)
        vy_t = jnp.concatenate([nan1, vy]).T
        pc1 = jax.vmap(lambda a, b: pc1_from_flow(a, b, pca_params))(vx_t, vy_t)
        return vx, vy, mag, pc1

    vx, vy, mag, pc1 = jax.vmap(one_video)(prev, curr, ex, ey, t_valid)
    cohort_mean = jnp.nanmean(mag, axis=(0, 1))
    return CohortStep(vx=vx, vy=vy, mag=mag, pc1=pc1, cohort_mean_mag=cohort_mean)


@functools.lru_cache(maxsize=8)
def cohort_chunk_step(mesh: Mesh, flow_params):
    """Sharded chunk program of the production cohort flow stage.

    Operands: frames (V, B+1, H, W), ex/ey (V, B, 2), masks
    (V, R, H, W) — the video axis is sharded over the mesh's "data"
    axis; each device runs roi_body_flow_seq over its local videos
    under lax.map, so the whole cohort chunk is
    ONE dispatched program.  Cached per (mesh, params) so repeated
    chunks reuse the compiled executable.
    """
    def local(fr, e1, e2, mk):
        def one(args):
            f, a, b, m = args
            feats = roi_body_flow_seq(f, a, b, m, flow_params)
            return feats.vx, feats.vy, feats.mag

        return jax.lax.map(one, (fr, e1, e2, mk))

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data")),
            out_specs=P("data"),
            check_vma=False,
        )
    )


def cohort_flow_sharded(items, flows, config, chunk_pairs: int, mesh: Mesh):
    """Stage A of run_cohort with the video axis sharded over a mesh.

    Eligible when every item is a uniform ndarray clip with the same
    ROI count (the vmapped/sharded layout of SURVEY §2.6 row 1 —
    reference comparison: none, optical_flow.py:222-250 is strictly
    serial).  Fills ``flows[i]`` for handled items and returns a
    per-item handled flag; callers fall back to the sequential path
    for the rest.  Per-video semantics (NaN frame 0, invalid-axes
    masking) are identical to run_flow_stage — equality-tested in
    tests/test_parallel.py.
    """
    from btcs_pnes_optical_flow.models.flow import skel_indices
    from btcs_pnes_optical_flow.models.pipeline import FlowStageResult
    from btcs_pnes_optical_flow.ops.cvx import fill_poly_mask

    n = len(items)
    done = [False] * n
    vids = [it.video for it in items]
    # Device-resident clips (jax.Array) are first-class cohort inputs:
    # the chunk program then slices frames on device and the host→device
    # staging cost is paid once, wherever the caller chose to pay it
    # (e.g. overlapped with upstream decode) — not once per chunk here.
    on_device = all(isinstance(v, jax.Array) and v.ndim == 3 for v in vids)
    if not on_device and not all(
        isinstance(v, np.ndarray) and v.ndim == 3 for v in vids
    ):
        return done
    if len({v.shape for v in vids}) != 1:
        return done
    if len({len(it.roi_polygons) for it in items}) != 1:
        return done
    t_frames, h, w = vids[0].shape
    n_pairs_total = t_frames - 1
    if n_pairs_total <= 0:
        return done
    ndev = mesh.size
    pad_v = (-n) % ndev

    masks_np = np.stack(
        [np.stack([fill_poly_mask(h, w, p) for p in it.roi_polygons]) for it in items]
    )
    n_roi = masks_np.shape[1]

    # Host-side per-video timestamp/axis prep (ndarray sources have no
    # container POS_MSEC: t = idx/fps, optical_flow.py:110-119).
    t_sec, sk_all, ex_p, ey_p, ok_p = [], [], [], [], []
    for it in items:
        t = np.arange(t_frames, dtype=np.float64) / float(it.skeleton.fps)
        sk = skel_indices(t, it.skeleton.time_all)
        ex = it.skeleton.ex[sk][1:]
        ey = it.skeleton.ey[sk][1:]
        ok = np.isfinite(ex).all(axis=1) & np.isfinite(ey).all(axis=1)
        t_sec.append(t)
        sk_all.append(sk)
        ex_p.append(np.where(ok[:, None], ex, 0.0).astype(np.float32))
        ey_p.append(np.where(ok[:, None], ey, 0.0).astype(np.float32))
        ok_p.append(ok)

    def vpad(x):
        return np.concatenate([x, np.repeat(x[-1:], pad_v, axis=0)]) if pad_v else x

    if on_device:
        frames_all = jnp.stack(vids).astype(jnp.uint8)
        if pad_v:
            frames_all = jnp.concatenate(
                [frames_all, jnp.repeat(frames_all[-1:], pad_v, axis=0)]
            )
    else:
        frames_all = vpad(np.stack(vids)).astype(np.uint8)  # ArraySource semantics
    # Mesh-explicit placement: the video axis is sharded over "data" so
    # the chunk program never re-shards, and the whole path works when
    # the mesh's devices are not the default backend.
    _data = NamedSharding(mesh, P("data"))
    masks_dev = jax.device_put(vpad(masks_np), _data)
    ex_all = vpad(np.stack(ex_p))
    ey_all = vpad(np.stack(ey_p))

    vx = np.empty((n, n_pairs_total, n_roi), np.float64)
    vy = np.empty_like(vx)
    mg = np.empty_like(vx)
    pending = []

    def resolve(entry):
        s, b_eff, out = entry
        o_vx, o_vy, o_mag = (np.asarray(x) for x in out)
        for i in range(n):
            cvx_ = o_vx[i][:b_eff].astype(np.float64)
            cvy = o_vy[i][:b_eff].astype(np.float64)
            cmg = o_mag[i][:b_eff].astype(np.float64)
            inv = ~ok_p[i][s : s + b_eff]
            cvx_[inv] = np.nan
            cvy[inv] = np.nan
            cmg[inv] = np.nan
            vx[i, s : s + b_eff] = cvx_
            vy[i, s : s + b_eff] = cvy
            mg[i, s : s + b_eff] = cmg

    xp = jnp if on_device else np
    for s in range(0, n_pairs_total, chunk_pairs):
        b_eff = min(chunk_pairs, n_pairs_total - s)
        fr = frames_all[:, s : s + chunk_pairs + 1]
        if b_eff < chunk_pairs:  # static tail: repeat the last frame
            reps = xp.repeat(fr[:, -1:], chunk_pairs - fr.shape[1] + 1, axis=1)
            fr = xp.concatenate([fr, reps], axis=1)
        ex_c = np.zeros((n + pad_v, chunk_pairs, 2), np.float32)
        ey_c = np.zeros_like(ex_c)
        ex_c[:, :b_eff] = ex_all[:, s : s + b_eff]
        ey_c[:, :b_eff] = ey_all[:, s : s + b_eff]
        out = cohort_chunk_step(mesh, config.flow)(
            jax.device_put(fr, _data), jax.device_put(ex_c, _data),
            jax.device_put(ey_c, _data), masks_dev,
        )
        pending.append((s, b_eff, out))
        while len(pending) > 2:
            resolve(pending.pop(0))
    for entry in pending:
        resolve(entry)

    for i, it in enumerate(items):
        nanrow = np.full((1, n_roi), np.nan)
        axes_ok_frames = np.concatenate([[False], ok_p[i]])
        # Frame-0 axes validity follows the frame's own skeleton row
        # (it has no pair, so features are NaN regardless).
        ex0 = it.skeleton.ex[sk_all[i][0]]
        ey0 = it.skeleton.ey[sk_all[i][0]]
        axes_ok_frames[0] = bool(np.isfinite(ex0).all() and np.isfinite(ey0).all())
        flows[i] = FlowStageResult(
            frame=np.arange(t_frames),
            t_sec=t_sec[i],
            skel_idx=sk_all[i],
            axes_ok=axes_ok_frames,
            vx=np.concatenate([nanrow, vx[i]]),
            vy=np.concatenate([nanrow, vy[i]]),
            mag=np.concatenate([nanrow, mg[i]]),
        )
        done[i] = True
    return done


def shard_cohort_inputs(mesh: Mesh, prev, curr, ex, ey, masks, t_valid):
    """Place cohort inputs: video axis sharded, masks replicated."""
    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def put(x, s):
        return jax.device_put(x, s)

    return (
        put(prev, NamedSharding(mesh, P("data", None, None, None))),
        put(curr, NamedSharding(mesh, P("data", None, None, None))),
        put(ex, NamedSharding(mesh, P("data", None, None))),
        put(ey, NamedSharding(mesh, P("data", None, None))),
        put(masks, repl),
        put(t_valid, NamedSharding(mesh, P("data", None))),
    )
