"""CUDA banded DP kernel (ops/cuda/extd2.cuh) behind the XLA FFI.

``extd2_cuda`` is the GPU branch of ops/dp.py::extd2 and returns exactly
what ops/dp.py::extd2_batch returns for score and dirs. The shared library
is compiled from the repository's sources with nvcc for sm_90a the first
time a program is traced where a CUDA device exists, cached under
``<repo>/.build`` by source hash, and registered as the FFI target
``gdiet_extd2``. A failed build raises: there is no other path on the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from gdiet_tpu.ops.dp import _round_up, dp_scoring, window_geometry

SRC_DIR = pathlib.Path(__file__).parent / "cuda"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".build"
TARGET = "gdiet_extd2"
# lane-state scratch of extd2.cuh's Slots<0> kernel, which a row wider than
# one warp (256 lanes) takes when its register group would be too large:
# kFields int32 per slot, at most W + 1023 slots (groups of <= 1024 threads)
SCRATCH_FIELDS = 9
MAX_GROUP = 1024
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_registered = False
_register_lock = threading.Lock()  # programs may be traced from threads


def kernel_config(params: tuple, Lmax: int, Lt: int,
                  band_budget: int | None) -> tuple[np.ndarray, int, int]:
    """(cfg, R, W): the kernel's int32 attribute vector (field order of
    Extd2Args from Lmax to long_diff), the wavefront count and the dirs row
    width — the geometry of ops/dp.py::extd2_batch."""
    T = _round_up(Lt, 16)
    WB = window_geometry(band_budget, Lt) if band_budget is not None else None
    TS = _round_up(Lt, 128) if WB else T
    W = WB or T
    R = Lmax + Lt - 1
    cfg = np.array([Lmax, Lt, R, T, TS, W, band_budget if WB else -1,
                    *dp_scoring(params)], np.int32)
    return cfg, R, W


def build_library() -> pathlib.Path:
    """Compile the FFI library (cached by source hash); returns its path."""
    srcs = sorted(SRC_DIR.glob("extd2*.cu*"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.read_bytes())
    out = BUILD_DIR / f"lib{TARGET}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", str(tmp),
           str(SRC_DIR / "extd2_ffi.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _ensure_registered() -> None:
    global _registered
    with _register_lock:
        if _registered or not any(d.platform == "gpu" for d in jax.devices()):
            return
        lib = ctypes.cdll.LoadLibrary(str(build_library()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.GdietExtd2), platform="CUDA")
        _registered = True


def extd2_cuda(query, target, qlens, tlens, band, *, params: tuple,
               Lmax: int, Lt: int, band_budget: int | None = None):
    """(score [N] int32, dirs [N, R, W] uint8) from the CUDA kernel for
    query [N, Lmax] / target [N, Lt] uint8 codes and int32 qlens, tlens and
    band (every band <= band_budget when the window is on)."""
    _ensure_registered()
    cfg, R, W = kernel_config(params, Lmax, Lt, band_budget)
    N = query.shape[0]
    scratch = N * SCRATCH_FIELDS * (W + MAX_GROUP) if W > 256 else 1
    if target.shape[1] != Lt:
        target = jnp.zeros((N, Lt), jnp.uint8).at[:, : target.shape[1]].set(
            target[:, :Lt].astype(jnp.uint8))
    score, dirs, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((N,), jnp.int32),
         jax.ShapeDtypeStruct((N, R, W), jnp.uint8),
         jax.ShapeDtypeStruct((scratch,), jnp.int32)),
    )(query.astype(jnp.uint8), target.astype(jnp.uint8), qlens, tlens, band,
      cfg=cfg)
    return score, dirs
