"""Probe: pooled-BA pose accuracy vs matcher richness (round-4 task: push
dR under ~3e-4 rad by raising pooled inlier support).

Runs match -> autocalibrate on cached synthetic scenes and reports per-frame
match counts, the pooled inlier count, and dR/dT vs ground truth.

Env knobs: W, H, FRAMES, NUM_FEATURES, NNDR, CANDS, SUBSET.
Scenes must be pre-rendered by bench.py's cache (seeds 900+i).
"""

import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

from wass_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from wass_tpu.cli.pipeline import SequenceConfig, SequencePipeline
from wass_tpu.match.pipeline import MatchConfig
from wass_tpu.testing.synthetic import SyntheticRig

W = int(os.environ.get("W", "1536"))
H = int(os.environ.get("H", "1152"))
FRAMES = int(os.environ.get("FRAMES", "8"))

frames = []
rig = None
for i in range(FRAMES):
    t = i * 0.2
    cache = Path(f"/tmp/wass_bench_scene_{W}x{H}_{900+i}_{t:g}.npz")
    z = np.load(cache)
    rig = SyntheticRig(width=W, height=H, **{k: z[k] for k in ("K0", "K1", "R0", "T0", "R1", "T1")})
    frames.append((z["img0"], z["img1"]))

mc = MatchConfig(
    num_features=int(os.environ.get("NUM_FEATURES", "2000")),
    nndr=float(os.environ.get("NNDR", "0.25")),
    n_candidates_per_feature=int(os.environ.get("CANDS", "3")),
)
root = Path("/tmp/wass_probe_autocal")
shutil.rmtree(root, ignore_errors=True)
pipe = SequencePipeline(root, SequenceConfig(match=mc, match_subset=int(os.environ.get("SUBSET", "50"))))
pipe.prepare(frames, rig.K0, np.zeros(5), rig.K1, np.zeros(5))

t0 = time.time()
n_ok = pipe.match()
t_match = time.time() - t0
counts = []
for wd in pipe.workdirs():
    try:
        a, _ = wd.load_matches("matches_epionly.txt")
        counts.append(len(a))
    except FileNotFoundError:
        counts.append(0)
print(f"matched {n_ok}/{FRAMES} in {t_match:.1f}s; epionly per frame: {counts} (sum {sum(counts)})")

t0 = time.time()
res = pipe.autocalibrate()
Tg = rig.T / np.linalg.norm(rig.T)
dR = float(np.abs(res.R - rig.R).max())
dT = float(np.abs(res.T.ravel() - Tg).max())
print(
    f"autocal {time.time()-t0:.1f}s: pooled inliers {res.n_inliers}, "
    f"dR {dR:.3e} (target 3e-4, gate 5e-3), dT {dT:.3e} (gate 2e-2), "
    f"epi before/after {res.epi_med_before:.4f}/{res.epi_med_after:.4f} px"
)
