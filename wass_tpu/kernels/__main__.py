"""Build the CUDA kernel library: python -m wass_tpu.kernels"""

from wass_tpu.kernels import build

print(build())
