"""wass_tpu — sea-wave stereo reconstruction in JAX, on an NVIDIA GPU.

A JAX program with the capabilities of WASS
(Waves Acquisition Stereo System): given synchronized stereo image
sequences of the sea surface and known camera intrinsics, recover the
stereo extrinsics, reconstruct dense 3D point clouds of the wave field,
fit the mean sea plane, grid the scattered clouds onto a regular
sea-plane-aligned surface, and compute wave spectra.

Unlike the reference (four single-threaded C++ executables coordinated by
a shared filesystem), the whole pipeline here is a set of pure, jittable,
batched stage functions over fixed-shape arrays, designed to shard frame
pairs across the GPUs of a device mesh and solve the sequence-wide bundle adjustment with
a distributed Schur complement.

Layout (mirrors SURVEY.md §2's component inventory):
  core/      geometry: cameras, triangulation, epipolar metrics, rectification
  ops/       image ops: sampling/undistort, morphology, components, CLAHE
  stereo/    dense stage: census/SGM disparity, filtering, triangulation, plane
  match/     sparse stage: features, game-theoretic matching, E-RANSAC, pose
  calib/     sequence bundle adjustment (LM + Schur complement)
  prepare/   image preparation: undistortion, CLAHE, polarimetric processing
  grid/      point cloud -> regular surface gridding + interpolation
  post/      wave spectra, filters, visibility analytics
  parallel/  mesh construction, frame-sharded runners, distributed BA
  io/        workdir file contract (XML matrices, .xyzC, configs, NetCDF)
  cli/       wasscli-equivalent pipeline driver
"""

__version__ = "0.1.0"

from wass_tpu import config as config  # noqa: F401
