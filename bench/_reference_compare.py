"""Reference-class sparse-pipeline head-to-head under sensor noise.

The noise sigma=8 row has no passing configuration in our matcher
(bench/robustness.py noise_s8_sweep).  To establish whether that is an
implementation gap or a signal floor, this runs the same pooled-pose
protocol through OpenCV's classical sparse pipeline — SIFT (this cv2
build has no KAZE; SIFT is the same detector class the reference chose
KAZE over, /root/reference/src/wass_match/FeatureSet.cpp:199) + ratio
test + findEssentialMat(RANSAC) per frame + pooled-inlier essential
re-estimation + recoverPose — on the identical scenes/degradations.

The scene's surface texture measures ~0.4 gray levels of mean gradient;
sigma=8 noise is ~20x above the signal.  If the OpenCV pipeline also
blows the pose gates there (and passes clean), the sigma=8 failure is a
physics limit of the imagery, not of our matcher.

Run: python bench/_reference_compare.py   (CPU only, ~2 min)
"""
import sys

sys.path.insert(0, "/root/repo")
sys.path.insert(0, "/root/repo/bench")

import numpy as np


def main():
    import cv2

    from robustness import _canonical_rig_scene, add_noise

    W, H = 1024, 768
    n_frames = 8
    frames, rig = [], None
    for i in range(n_frames):
        img0, img1, _, rig = _canonical_rig_scene(W, H, seed=17, time_s=i * 0.2)
        frames.append((img0, img1))
    K = np.asarray(rig.K0, np.float64)
    Tg = (rig.T / np.linalg.norm(rig.T)).ravel()

    sift = cv2.SIFT_create(nfeatures=2000)
    bf = cv2.BFMatcher()

    cases = [
        ("clean", lambda im, s: im),
        ("noise s=3", lambda im, s: add_noise(im, 3, s)),
        ("noise s=8", lambda im, s: add_noise(im, 8, s)),
    ]
    print("| degradation | pooled inliers | dR (<=5e-3) | dT (<=2e-2) | verdict |")
    print("|---|---|---|---|---|")
    for name, fn in cases:
        p0_all, p1_all = [], []
        for i, (f0, f1) in enumerate(frames):
            d0 = np.clip(fn(f0.astype(np.float64), 1 + 2 * i), 0, 255).astype(np.uint8)
            d1 = np.clip(fn(f1.astype(np.float64), 2 + 2 * i), 0, 255).astype(np.uint8)
            k0, des0 = sift.detectAndCompute(d0, None)
            k1, des1 = sift.detectAndCompute(d1, None)
            if des0 is None or des1 is None or len(k0) < 8 or len(k1) < 8:
                continue
            good = []
            for m_pair in bf.knnMatch(des0, des1, k=2):
                if len(m_pair) == 2 and m_pair[0].distance < 0.8 * m_pair[1].distance:
                    good.append(m_pair[0])
            if len(good) < 8:
                continue
            p0 = np.float64([k0[m.queryIdx].pt for m in good])
            p1 = np.float64([k1[m.trainIdx].pt for m in good])
            E, mask = cv2.findEssentialMat(p0, p1, K, method=cv2.RANSAC,
                                           prob=0.9999, threshold=0.5)
            if E is None or mask is None:
                continue
            inl = mask.ravel().astype(bool)
            p0_all.append(p0[inl])
            p1_all.append(p1[inl])
        if not p0_all:
            print(f"| {name} | 0 | - | - | NO POSE |")
            continue
        P0 = np.concatenate(p0_all)
        P1 = np.concatenate(p1_all)
        E, mask = cv2.findEssentialMat(P0, P1, K, method=cv2.RANSAC,
                                       prob=0.9999, threshold=0.5)
        _, R, T, pm = cv2.recoverPose(E, P0, P1, K, mask=mask)
        dR = float(np.abs(R - rig.R).max())
        dT = float(np.abs(T.ravel() - Tg).max())
        n_in = int(mask.sum())
        verdict = "PASS" if (dR <= 5e-3 and dT <= 2e-2) else "FAIL"
        print(f"| {name} | {n_in} | {dR:.1e} | {dT:.1e} | {verdict} |")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
