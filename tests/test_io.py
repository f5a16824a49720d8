"""IO layer tests: native C++ loader, prefetcher, checkpoint/resume."""

import os
import numpy as np
import pytest

from btcs_pnes_optical_flow.dataio.checkpoint import ChunkStore
from btcs_pnes_optical_flow.dataio.video import ArraySource, ChunkPrefetcher


def test_native_source_gray_exact(tmp_path, rng):
    from btcs_pnes_optical_flow.dataio.native import NativeSource

    g = rng.integers(0, 256, (12, 32, 40)).astype(np.uint8)
    p = str(tmp_path / "g.npy")
    np.save(p, g)
    src = NativeSource(p, fps=30)
    got = np.stack([f for f, _ in src.frames()])
    np.testing.assert_array_equal(got, g)
    np.testing.assert_array_equal(src.read(5), g[5])
    src.close()


def test_native_source_bgr_matches_jax_gray(tmp_path, rng):
    import jax.numpy as jnp

    from btcs_pnes_optical_flow.dataio.native import NativeSource
    from btcs_pnes_optical_flow.ops.cvx import bgr2gray_u8

    b = rng.integers(0, 256, (6, 24, 30, 3)).astype(np.uint8)
    p = str(tmp_path / "b.npy")
    np.save(p, b)
    want = np.asarray(bgr2gray_u8(jnp.asarray(b)))
    src = NativeSource(p, fps=25)
    got = np.stack([f for f, _ in src.frames()])
    np.testing.assert_array_equal(got, want)
    src.close()


def test_prefetcher_chunking(rng):
    frames = rng.integers(0, 256, (23, 8, 8)).astype(np.uint8)
    src = ArraySource(frames, fps=30.0)
    seen_pairs = []
    for first, chunk, pos in ChunkPrefetcher(src, chunk_pairs=5):
        for i in range(1, len(chunk)):
            seen_pairs.append(first + i)
            np.testing.assert_array_equal(chunk[i], frames[first + i])
            np.testing.assert_array_equal(chunk[i - 1], frames[first + i - 1])
    assert seen_pairs == list(range(1, 23))


def test_chunk_store_roundtrip(tmp_path, rng):
    store = ChunkStore(str(tmp_path / "ck"), meta={"chunk_pairs": 4})
    store.save(0, vx=np.arange(4.0), vy=np.zeros(4))
    store.save(4, vx=np.arange(4.0) + 4, vy=np.ones(4))
    assert store.completed_chunks() == [0, 4]
    assert store.has(4) and not store.has(8)
    got = store.load(4)
    np.testing.assert_array_equal(got["vx"], np.arange(4.0) + 4)
    # Meta mismatch must refuse to resume.
    with pytest.raises(ValueError):
        ChunkStore(str(tmp_path / "ck"), meta={"chunk_pairs": 8})


def test_flow_stage_resume(tmp_path, rng, monkeypatch):
    """Second run with a checkpoint dir must not recompute chunks."""
    from btcs_pnes_optical_flow.dataio import contracts
    from btcs_pnes_optical_flow.models import pipeline
    from tests.test_pipeline import ROI, make_skeleton, render_clip

    clip = render_clip(n_frames=40)
    skel = make_skeleton(len(clip))
    ck = str(tmp_path / "ck")
    a = pipeline.run_flow_stage(
        ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=16, checkpoint_dir=ck
    )
    calls = []
    import btcs_pnes_optical_flow.models.pipeline as pl

    real = pl.roi_body_flow_seq

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(pl, "roi_body_flow_seq", spy)
    b = pipeline.run_flow_stage(
        ArraySource(clip, fps=30.0), skel, [ROI], chunk_pairs=16, checkpoint_dir=ck
    )
    assert not calls, "flow recomputed despite checkpoints"
    fin = np.isfinite(a.vx)
    np.testing.assert_array_equal(fin, np.isfinite(b.vx))
    np.testing.assert_allclose(a.vx[fin], b.vx[fin], atol=0)


def _write_y4m(path, frames, marker=b"FRAME\n"):
    h, w = frames.shape[1:]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 Cmono\n".encode())
        for fr in frames:
            f.write(marker)
            f.write(fr.tobytes())


def test_y4m_frame_markers_with_params(tmp_path, rng):
    """Y4M spec allows 'FRAME <params>\\n'; both readers must not
    misalign luma when markers carry (constant) parameters."""
    from btcs_pnes_optical_flow.dataio.native import NativeSource
    from btcs_pnes_optical_flow.dataio.video import Y4MSource

    frames = rng.integers(0, 256, (5, 16, 24)).astype(np.uint8)
    p = str(tmp_path / "p.y4m")
    _write_y4m(p, frames, marker=b"FRAME Xsomething\n")

    src = Y4MSource(p)
    assert src.n_frames == 5
    got = np.stack([f for f, _ in src.frames()])
    np.testing.assert_array_equal(got, frames)

    nsrc = NativeSource(p)
    ngot = np.stack([f for f, _ in nsrc.frames()])
    np.testing.assert_array_equal(ngot, frames)
    nsrc.close()


def test_native_y4m_rejects_variable_markers(tmp_path, rng):
    """Variable-length frame markers can't use the fixed-stride native
    reader — opening must fail loudly, not return garbage luma."""
    from btcs_pnes_optical_flow.dataio.native import NativeSource

    frames = rng.integers(0, 256, (3, 8, 8)).astype(np.uint8)
    p = str(tmp_path / "v.y4m")
    h, w = 8, 8
    with open(p, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Cmono\n".encode())
        for i, fr in enumerate(frames):
            f.write(b"FRAME\n" if i % 2 == 0 else b"FRAME X1\n")
            f.write(fr.tobytes())
    with pytest.raises((RuntimeError, ValueError, OSError)):
        NativeSource(p)


def test_mjpeg_avi_native_decode(tmp_path, rng):
    """Native RIFF walk + PIL JPEG decode must match cv2.VideoCapture
    on a real MJPEG AVI (written by OpenCV, read without it)."""
    cv2 = pytest.importorskip("cv2")
    from btcs_pnes_optical_flow.dataio.codecs import MJPEGAviSource

    h, w, n = 48, 64, 6
    # Gray content in all three channels: flat chroma removes the
    # 4:2:0 upsampling-filter differences between libjpeg consumers, so
    # the comparison isolates the container walk + luma decode.
    g1 = rng.integers(0, 256, (n, h, w, 1)).astype(np.uint8)
    frames = np.repeat(g1, 3, axis=-1)
    p = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (w, h))
    assert vw.isOpened()
    for fr in frames:
        vw.write(fr)
    vw.release()

    src = MJPEGAviSource(p)
    assert src.n_frames == n
    assert (src.width, src.height) == (w, h)
    assert abs(src.fps - 25.0) < 1e-6
    got = [(f, pm) for f, pm in src.frames()]
    assert len(got) == n
    # pos_msec is reported after each read, frame i at (i+1)/fps.
    assert abs(got[0][1] - 40.0) < 1e-6

    cap = cv2.VideoCapture(p)
    for i, (g, _) in enumerate(got):
        ok, bgr = cap.read()
        assert ok
        want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        # Same JPEG bitstream; PIL vs cv2 differ only in luma rounding
        # (ITU 601 in both) and IDCT implementation: ±2 levels.
        assert np.abs(g.astype(int) - want.astype(int)).max() <= 2
    cap.release()


def test_open_source_prefers_cv2_free_decoder(tmp_path, rng):
    """open_source must route .avi files to the native decoder (no
    cv2 required on the production input path)."""
    cv2 = pytest.importorskip("cv2")
    from btcs_pnes_optical_flow.dataio.codecs import (
        MJPEGAviSource,
        ffmpeg_binary,
    )
    from btcs_pnes_optical_flow.dataio.video import open_source

    if ffmpeg_binary() is not None:
        pytest.skip("ffmpeg present: dispatch prefers FFmpegSource")
    h, w = 32, 32
    p = str(tmp_path / "d.avi")
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (w, h))
    for _ in range(3):
        vw.write(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    vw.release()
    src = open_source(p)
    assert isinstance(src, MJPEGAviSource)


def _install_fake_ffmpeg(tmp_path, monkeypatch, npy_path, h, w, fps):
    """A hermetic ffmpeg stand-in: probe mode prints a stream line to
    stderr and exits 1 (exactly like `ffmpeg -i file` with no output);
    decode mode streams the .npy frames as raw gray8 on stdout.  Lets
    FFmpegSource — the designated production decoder — execute under
    the suite on hosts with no ffmpeg binary."""
    import stat
    import sys as _sys

    script = tmp_path / "ffmpeg"
    script.write_text(
        f"""#!{_sys.executable}
import sys
import numpy as np
args = sys.argv[1:]
path = args[args.index("-i") + 1]
if "rawvideo" not in args:
    sys.stderr.write(
        "Input #0, fake, from '%s':\\n"
        "  Stream #0:0: Video: rawvideo, gray, {w}x{h}, {fps} fps, {fps} tbr\\n"
        % path
    )
    sys.exit(1)
frames = np.load(path.removesuffix(".fake") + ".npy")
sys.stdout.buffer.write(frames.tobytes())
sys.exit(0)
"""
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ.get('PATH', '')}")
    return script


def test_ffmpeg_source_decodes_and_timestamps(tmp_path, monkeypatch, rng):
    """FFmpegSource end to end against ArraySource ground truth: probe
    parsing (size/fps from the stderr stream line), raw-gray8 pipe
    decode, and the POS_MSEC-after-read timestamp rule
    (reference optical_flow.py:62-85,110-119)."""
    from btcs_pnes_optical_flow.dataio.codecs import FFmpegSource, ffmpeg_binary

    h, w, n, fps = 48, 64, 5, 25.0
    frames = rng.integers(0, 256, (n, h, w)).astype(np.uint8)
    np.save(tmp_path / "clip.npy", frames)
    _install_fake_ffmpeg(tmp_path, monkeypatch, tmp_path / "clip.npy", h, w, fps)
    assert ffmpeg_binary() is not None

    src = FFmpegSource(str(tmp_path / "clip.fake"))
    assert (src.width, src.height) == (w, h)
    assert abs(src.fps - fps) < 1e-6
    ref = ArraySource(frames, fps=fps)
    got = list(src.frames())
    want = list(ref.frames())
    assert len(got) == n
    for i, ((g, pm), (r, _)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, r)
        assert abs(pm - 1000.0 * (i + 1) / fps) < 1e-9  # POS_MSEC after read


def test_ffmpeg_source_real_binary_roundtrip(tmp_path, rng):
    """When a real ffmpeg exists, synthesize a y4m clip with it and
    decode through FFmpegSource, asserting luma vs the raw frames."""
    import shutil
    import subprocess

    from btcs_pnes_optical_flow.dataio.codecs import FFmpegSource

    bin_ = shutil.which("ffmpeg")
    if bin_ is None:
        pytest.skip("no real ffmpeg binary on PATH")
    h, w, n, fps = 48, 64, 5, 25
    frames = rng.integers(0, 256, (n, h, w)).astype(np.uint8)
    raw = tmp_path / "clip.gray"
    raw.write_bytes(frames.tobytes())
    out = str(tmp_path / "clip.y4m")
    subprocess.run(
        [bin_, "-f", "rawvideo", "-pix_fmt", "gray", "-s", f"{w}x{h}",
         "-r", str(fps), "-i", str(raw), "-pix_fmt", "yuv420p", out],
        check=True, capture_output=True,
    )
    src = FFmpegSource(out)
    assert (src.width, src.height) == (w, h)
    got = [f for f, _ in src.frames()]
    assert len(got) == n
    for g, r in zip(got, frames):
        # gray -> yuv420p -> gray: luma is lossless up to rounding
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
