"""Hand-written CUDA kernels, built with nvcc and called through jax.ffi.

The sources (*.cu in this directory) are compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ``_build/`` (listed in
.gitignore) the first time a kernel is used on a GPU, or ahead of time with

    python -m wass_tpu.kernels

The library name carries a hash of the sources and the build flags, so a
changed source is rebuilt and a stale library is never loaded.  On a GPU a
failed build or load raises: there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).parent
_BUILD_DIR = _DIR / "_build"
_SOURCES = ("sgm_aggregate.cu",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# FFI targets exported by the library: registered name -> C symbol.
_TARGETS = {"wass_sgm_aggregate": "WassSgmAggregate"}

_lock = threading.Lock()
_registered = False


class KernelBuildError(RuntimeError):
    """The CUDA kernel library could not be built, loaded or registered."""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(include_dir: str) -> list:
    return [*_ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", include_dir]


def library_path() -> Path:
    """Path of the library built from the current sources."""
    import jax.ffi

    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(_flags(jax.ffi.include_dir())).encode())
    return _BUILD_DIR / f"libwass_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    import jax.ffi

    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(jax.ffi.include_dir()), "-o", str(tmp)]
    cmd += [str(_DIR / s) for s in _SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def ensure_registered() -> None:
    """Build and load the library and register its FFI targets for CUDA."""
    global _registered
    if _registered:
        return
    with _lock:
        if _registered:
            return
        import jax.ffi

        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        for name, symbol in _TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA"
            )
        _registered = True

