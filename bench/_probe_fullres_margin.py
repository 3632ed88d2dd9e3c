"""Probe: full-resolution (2048x1536) match-count margin vs detector knobs.

The clean full-res row measured 437 matches vs the
>=400 gate (verify_matcher.m:5-6) — a 1.1x margin.  The reference budgets
2000 features at any resolution (wass_match.cpp:39); at 3 MP that budget
under-samples the image (0.06% of pixels vs 0.26% at 1 MP).  This probe
sweeps detector capacity / NMS density to find a config giving >=600
matches with no epipolar-error regression (<= 0.177 px clean), on the
IDENTICAL scene/protocol as bench/robustness.py fullres_matcher_sweep.

Run: python bench/_probe_fullres_margin.py  (on a GPU)
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import importlib.util

_spec = importlib.util.spec_from_file_location(
    "wass_robustness", os.path.join(os.path.dirname(os.path.abspath(__file__)), "robustness.py")
)
_rob = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_rob)
_canonical_rig_scene = _rob._canonical_rig_scene
from wass_tpu.match.pipeline import MatchConfig, match_frame

W, H = 2048, 1536
img0, img1, _, rig = _canonical_rig_scene(W, H, seed=17)
Tn = rig.T / np.linalg.norm(rig.T)

variants = [
    ("baseline nf=2000", dict()),
    ("nf=4000", dict(num_features=4000)),
    ("nf=4000 cell=8", dict(num_features=4000, feature_grid_cell=8)),
    ("nf=6000 cell=8", dict(num_features=6000, feature_grid_cell=8)),
    ("nf=4000 cell=8 hess=5e-5", dict(num_features=4000, feature_grid_cell=8, hessian_threshold=5e-5)),
    ("nf=4000 cell=8 iid=30k", dict(num_features=4000, feature_grid_cell=8, iidyn_iters=30000)),
]

for name, kw in variants:
    cfg = MatchConfig(**kw)
    t0 = time.time()
    try:
        res = match_frame(img0.astype(np.float64), img1.astype(np.float64), rig.K0, rig.K1, cfg)
    except Exception as e:
        print(f"{name:34s} ERROR {type(e).__name__}: {e}")
        continue
    dt = time.time() - t0
    if res is None:
        print(f"{name:34s} FAILED (None)")
        continue
    dR = np.abs(res.R - rig.R).max()
    dT = np.abs(res.T.ravel() - Tn).max()
    print(
        f"{name:34s} n={res.n_matches:5d} epi={res.epi_avg:.3f}px "
        f"dR={dR:.1e} dT={dT:.1e} {dt:.1f}s"
    )
