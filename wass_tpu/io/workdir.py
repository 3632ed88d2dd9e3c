"""The per-frame working-directory contract.

The reference's stages communicate exclusively through per-frame workdirs
(documented file list:
/root/reference/doc/src/render/documentation/getting_started.html.md:208-230).
We keep the same layout as our external API so that wassgridsurface, the
Matlab verifiers, and any existing WASS tooling can consume our outputs:

  <seq>/NNNNNN_wd/
      undistorted/00000000.png  00000001.png
      intrinsics_00000000.xml   intrinsics_00000001.xml
      ext_R.xml ext_T.xml            (matcher / autocalibrate output)
      matches.txt matches_epionly.txt matcher_stats.csv
      P0cam.txt P1cam.txt Cam{0,1}_pose{R,T}.txt
      mesh_cam.xyzC plane.txt
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from wass_tpu.io import matrices
from wass_tpu.io.xyzc import save_xyz_compressed, load_camera_mesh


class Workdir:
    def __init__(self, path):
        self.path = Path(path)

    def create(self):
        (self.path / "undistorted").mkdir(parents=True, exist_ok=True)
        return self

    # --- images -----------------------------------------------------------
    def undistorted_path(self, cam: int) -> Path:
        return self.path / "undistorted" / f"{cam:08d}.png"

    def save_undistorted(self, cam: int, img: np.ndarray) -> None:
        from wass_tpu.io.png import write_gray

        write_gray(self.undistorted_path(cam), img)

    def load_undistorted(self, cam: int) -> np.ndarray:
        from wass_tpu.io.png import read_gray

        return np.asarray(read_gray(self.undistorted_path(cam)), dtype=np.float32)

    # --- matrices ---------------------------------------------------------
    def save_intrinsics(self, cam: int, K: np.ndarray) -> None:
        matrices.save_matrix_xml(self.path / f"intrinsics_{cam:08d}.xml", "intr", K)

    def load_intrinsics(self, cam: int) -> np.ndarray:
        return matrices.load_matrix(self.path / f"intrinsics_{cam:08d}.xml")

    def save_extrinsics(self, R: np.ndarray, T: np.ndarray) -> None:
        matrices.save_matrix_xml(self.path / "ext_R.xml", "ext_R", R)
        matrices.save_matrix_xml(self.path / "ext_T.xml", "ext_T", np.asarray(T).reshape(3, 1))

    def load_extrinsics(self):
        R = matrices.load_matrix(self.path / "ext_R.xml")
        T = matrices.load_matrix(self.path / "ext_T.xml")
        return R, T.reshape(3, 1)

    def has_extrinsics(self) -> bool:
        return (self.path / "ext_R.xml").exists() and (self.path / "ext_T.xml").exists()

    # --- matches ----------------------------------------------------------
    def save_matches(self, name: str, uv0: np.ndarray, uv1: np.ndarray) -> None:
        """Text match list (save_matches, wass_match.cpp:48-67): first line
        count, then "x0 y0 x1 y1" rows at 15 significant digits."""
        with open(self.path / name, "w") as f:
            f.write(f"{len(uv0)}\n")
            for (x0, y0), (x1, y1) in zip(uv0, uv1):
                f.write(f"{x0:.15g} {y0:.15g} {x1:.15g} {y1:.15g}\n")

    def load_matches(self, name: str):
        p = self.path / name
        with open(p) as f:
            n = int(f.readline())
            data = np.loadtxt(f, dtype=np.float64, ndmin=2) if n else np.zeros((0, 4))
        return data[:, :2], data[:, 2:4]

    def save_matcher_stats(self, n_matches: int, avg, std, mn, mx) -> None:
        with open(self.path / "matcher_stats.csv", "w") as f:
            f.write("N.Matches;Avg. Error;Std. Error;Min. Error;Max. Error\n")
            f.write(f"{n_matches};{avg:.15g};{std:.15g};{mn:.15g};{mx:.15g}\n")

    # --- stereo outputs ---------------------------------------------------
    def save_homography(self, H: np.ndarray) -> None:
        """H.xml: the 0->1 match homography (wass_autocalibrate.cpp:359,372)."""
        matrices.save_matrix_xml(self.path / "H.xml", "H", H)

    def save_plane(self, plane) -> None:
        """plane.txt: 4 coefficients, one per line, 20 digits
        (wass_stereo.cpp:2092-2100); 'nan nan nan nan' when RANSAC failed."""
        with open(self.path / "plane.txt", "w") as f:
            if plane is None or not np.all(np.isfinite(plane)):
                f.write("nan nan nan nan\n")
            else:
                for c in np.asarray(plane).reshape(4):
                    f.write(f"{c:.20g}\n")

    def load_plane(self) -> np.ndarray:
        return np.loadtxt(self.path / "plane.txt").reshape(-1)[:4]

    def save_mesh(self, pts_plane: np.ndarray, Rinv: np.ndarray, Tinv: np.ndarray) -> None:
        save_xyz_compressed(self.path / "mesh_cam.xyzC", pts_plane, Rinv, Tinv)

    def load_mesh_cam(self) -> np.ndarray:
        return load_camera_mesh(self.path / "mesh_cam.xyzC")

    def load_projection_matrices(self):
        return (
            np.loadtxt(self.path / "P0cam.txt"),
            np.loadtxt(self.path / "P1cam.txt"),
        )

    def save_projection_matrices(self, P0: np.ndarray, P1: np.ndarray) -> None:
        matrices.save_matrix_txt(self.path / "P0cam.txt", P0)
        matrices.save_matrix_txt(self.path / "P1cam.txt", P1)

    def save_camera_poses(self, R0, T0, R1, T1) -> None:
        matrices.save_matrix_txt(self.path / "Cam0_poseR.txt", R0)
        matrices.save_matrix_txt(self.path / "Cam0_poseT.txt", np.asarray(T0).reshape(3, 1))
        matrices.save_matrix_txt(self.path / "Cam1_poseR.txt", R1)
        matrices.save_matrix_txt(self.path / "Cam1_poseT.txt", np.asarray(T1).reshape(3, 1))


def frame_workdirs(sequence_dir) -> list:
    """All NNNNNN_wd frame workdirs of a sequence, sorted."""
    seq = Path(sequence_dir)
    return sorted(Workdir(p) for p in seq.glob("*_wd") if p.is_dir())


# Allow sorting Workdir objects by path.
Workdir.__lt__ = lambda self, other: str(self.path) < str(other.path)
