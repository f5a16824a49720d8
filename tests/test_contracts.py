"""CSV contracts without pandas: the writers stay byte-identical to
pandas' ``to_csv(index=False)``, and the main path runs where neither
pandas nor cv2 can be imported."""

import os
import subprocess
import sys

import numpy as np
import pytest

from btcs_pnes_optical_flow.dataio import contracts
from btcs_pnes_optical_flow.models.metrics import PC1Metrics
from btcs_pnes_optical_flow.utils.compile_cache import DEFAULT_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _columns(kind, rng):
    """Columns of each contract, with NaN rows and awkward floats."""
    n = 9
    vals = rng.normal(size=n) * 10.0 ** rng.integers(-6, 7, n)
    vals[[0, 4]] = np.nan
    if kind == "flow":
        return contracts.flow_columns(
            np.arange(n), np.arange(n) / 30.0, np.arange(n) // 2,
            np.arange(n) % 2, vals, -vals, np.abs(vals),
        )
    if kind == "pc1":
        return contracts.pc1_columns(np.arange(n) / 29.97, vals)
    if kind == "summary":
        m = PC1Metrics(0.1 + 0.2, -1e-5, np.nan, 0.30000000000000004, 1.0, 7, 0)
        return contracts.summary_columns(m, 10.0, "pc1_dyn")
    from btcs_pnes_optical_flow.parallel.runner import _table

    table = _table([
        ("a,b", 0, "pc1_dyn", 10.0, 1.5, np.nan, 0.25, 1 / 3, 2e-9, 4, 0, ""),
        ('v"2', 1, "pc1_dyn", 10.0, np.nan, np.nan, np.nan, np.nan, np.nan, 0, -1,
         "OSError: no such file"),
    ])
    return {name: table[name] for name in table.dtype.names}


@pytest.mark.parametrize("kind", ["flow", "pc1", "summary", "cohort"])
def test_csv_writer_matches_pandas(kind, rng, tmp_path):
    pd = pytest.importorskip("pandas")
    cols = _columns(kind, rng)
    mine, theirs = tmp_path / "mine.csv", tmp_path / "pandas.csv"
    contracts.write_csv(str(mine), cols)
    pd.DataFrame(cols).to_csv(theirs, index=False)
    assert mine.read_bytes() == theirs.read_bytes()
    back = contracts.read_csv(str(mine))
    assert list(back) == list(cols)
    for name, v in cols.items():
        if np.asarray(v).dtype.kind in "fi":
            np.testing.assert_array_equal(back[name], np.asarray(v, float))


_BLOCKED = """
import sys
sys.modules["pandas"] = None   # any import of pandas or cv2 now fails
sys.modules["cv2"] = None
sys.path.insert(0, {repo!r})
import numpy as np
from btcs_pnes_optical_flow.config import MetricParams, PipelineConfig
from btcs_pnes_optical_flow.dataio import contracts
from tests.test_pipeline import ROI, make_skeleton, render_clip

clip = render_clip(n_frames=96)
skel = make_skeleton(len(clip), nan_rows=((40, 44),))
video = {tmp!r} + "/clip.y4m"
h, w = clip.shape[1:]
with open(video, "wb") as f:
    f.write(f"YUV4MPEG2 W{{w}} H{{h}} F30:1 Ip A1:1 Cmono\\n".encode())
    for fr in clip:
        f.write(b"FRAME\\n" + fr.tobytes())
cfg = PipelineConfig(metrics=MetricParams(window_sec=3.0))
{body}
assert "pandas" not in sys.modules or sys.modules["pandas"] is None
print("BLOCKED_OK")
"""

_BODIES = {
    "run_full": """
from btcs_pnes_optical_flow.models import pipeline
flow, pc1, mets = pipeline.run_full(
    video, skel, [ROI], cfg, chunk_pairs=32, flow_csv={tmp!r} + "/f.csv",
    pc1_csv={tmp!r} + "/p.csv", summary_csv={tmp!r} + "/s.csv")
assert int(mets[0].status) == 0 and np.isfinite(pc1).any()
assert len(contracts.read_flow_csv({tmp!r} + "/f.csv")["t_sec"]) == 96
""",
    "run_cohort": """
from btcs_pnes_optical_flow.parallel.runner import CohortItem, run_cohort
rows = run_cohort([CohortItem("a", video, skel, [ROI]), CohortItem("b", clip, skel, [ROI])],
                  cfg, chunk_pairs=32, out_csv={tmp!r} + "/c.csv")
assert list(rows["status"]) == [0, 0] and list(rows["video"]) == ["a", "b"]
""",
    "compat": """
from btcs_pnes_optical_flow.compat import optical_PC1, optical_PCA, optical_flow
npz = {tmp!r} + "/skel.npz"
contracts.save_skeleton_npz(npz, skel)
optical_flow.main([video, npz, {tmp!r} + "/f.csv", repr(ROI.tolist())])
optical_PCA.main([{tmp!r} + "/f.csv", {tmp!r} + "/p.csv"])
optical_PC1.WINDOW_SEC = 3.0
optical_PC1.main([{tmp!r} + "/p.csv", {tmp!r} + "/s.csv"])
assert list(contracts.read_csv({tmp!r} + "/s.csv")) == contracts.SUMMARY_COLUMNS
""",
}


@pytest.mark.parametrize("entry", sorted(_BODIES))
def test_main_path_runs_without_pandas_or_cv2(entry, tmp_path):
    body = _BODIES[entry].format(tmp=str(tmp_path))
    code = _BLOCKED.format(repo=REPO, tmp=str(tmp_path), body=body)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.setdefault("JAX_COMPILATION_CACHE_DIR", DEFAULT_DIR)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "BLOCKED_OK" in r.stdout
