"""Hopper wavefront kernels (CUDA C++ called through ``jax.ffi``).

Sources live in ``kernels/csrc``: ``gx_cells.h`` holds the per-cell
recurrences and the per-lane sweep steps, ``gx_kernels.cu`` the kernels
and their FFI handlers, ``gx_cells_host.cc`` a host emulation of the
kernels' schedule that the CPU tests run against ``kernels/oracle.py``.

Both libraries are built from those sources into ``kernels/_build`` (listed
in ``.gitignore``) at first use, or ahead of time with::

    python -m genomax.kernels.cuda          # CUDA library + host emulation
    python -m genomax.kernels.cuda --host   # host emulation only

The kernels consume the packer's tiles as they are (int8 codes, pairs on
the last axis, the reversed stream) and return (NT, 128) results, the
same contract as the ``lax`` twins in ``kernels/wavefront.py``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

from genomax.config import SWConfig
from genomax.layout import LANES

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
_HEADER = os.path.join(_SRC, "gx_cells.h")
_CUDA_SRC = os.path.join(_SRC, "gx_kernels.cu")
_HOST_SRC = os.path.join(_SRC, "gx_cells_host.cc")
CUDA_LIB = os.path.join(BUILD_DIR, "libgx_cuda.so")
HOST_LIB = os.path.join(BUILD_DIR, "libgx_cells_host.so")

# Lanes per pair, and cells per lane the kernels are instantiated for
# (the header's GX_SW_COLS / GX_PHMM_COLS lists; tests/test_cuda.py
# checks that the two agree).
GROUPS = (4, 8, 16, 32)
SW_COLS = (4, 8, 9, 12, 16, 17, 24, 32, 33)
PHMM_COLS = (4, 6, 8, 10, 12, 16)
SW_MAX_X = GROUPS[-1] * SW_COLS[-1]  # longest x the SW kernel covers
PHMM_MAX_READ = GROUPS[-1] * PHMM_COLS[-1]

_lock = threading.Lock()
_registered = False
_host_lib = None


def _stale(lib: str, *srcs: str) -> bool:
    return not os.path.exists(lib) or any(
        os.path.getmtime(lib) < os.path.getmtime(s) for s in srcs)


def _compile(cmd: list[str], out: str) -> None:
    """Run a compiler into a temporary file, then move it into place, so
    concurrent first uses never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed (exit {r.returncode}):\n{r.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def build_cuda(force: bool = False) -> str:
    """Compile gx_kernels.cu for sm_90a into CUDA_LIB (if stale)."""
    if force or _stale(CUDA_LIB, _CUDA_SRC, _HEADER):
        nvcc = nvcc_path()
        if not os.path.exists(nvcc):
            raise RuntimeError(
                f"nvcc not found ({nvcc}); set CUDA_HOME to the CUDA toolkit")
        _compile([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                  "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                  "-I", jax.ffi.include_dir(), "-I", _SRC, _CUDA_SRC],
                 CUDA_LIB)
    return CUDA_LIB


def build_host(force: bool = False) -> str:
    """Compile the host emulation (g++) into HOST_LIB (if stale)."""
    if force or _stale(HOST_LIB, _HOST_SRC, _HEADER):
        _compile(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                  "-I", _SRC, _HOST_SRC], HOST_LIB)
    return HOST_LIB


def register() -> None:
    """Build (if needed) and register the FFI targets (idempotent)."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build_cuda())
        for name, sym in (("gx_sw_scores", lib.GxSwScores),
                          ("gx_pairhmm", lib.GxPairhmm)):
            jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                        platform="CUDA")
        _registered = True


# ---------------------------------------------------------------------------
# Launch shape: lanes per pair (group) x cells per lane (cols)
# ---------------------------------------------------------------------------


def choose_launch(n_cells: int, n_steps: int,
                  cols: tuple[int, ...]) -> tuple[int, int]:
    """(group, cols) covering ``n_cells`` sublane-fixed cells with the
    least work: group * cols lane cells per step over n_steps + group - 1
    skewed steps, plus a per-step cost of about three cells for the
    shuffles and the loop. Raises when no instantiation covers it."""
    best = None
    for g in GROUPS:
        for c in cols:
            if g * c < n_cells:
                continue
            cost = g * (c + 3) * (max(n_steps, 1) + g - 1)
            if best is None or cost < best[0]:
                best = (cost, g, c)
    if best is None:
        raise ValueError(f"{n_cells} cells exceed the kernel's "
                         f"{GROUPS[-1] * cols[-1]}-cell reach")
    return best[1], best[2]


def sw_launch(bucket) -> tuple[int, int]:
    """(group, cols) for one packed SW bucket."""
    return choose_launch(int(bucket.nx.max()) - 1, int(bucket.ny.max()) - 1,
                         SW_COLS)


def pairhmm_launch(bucket) -> tuple[int, int]:
    """(group, cols) for one packed PairHMM bucket."""
    return choose_launch(int(bucket.rl.max()), int(bucket.hl.max()),
                         PHMM_COLS)


# ---------------------------------------------------------------------------
# JAX entry points
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "launch"))
def sw_tiles(sx, sy, nx, ny, *, cfg: SWConfig, launch: tuple[int, int]):
    """SW scores of one bucket: sx (NT, NXs, 128) int8, sy (NT, NDs, 128)
    int8 reversed stream, nx/ny (NT*128,) int32 true dims (len + 1) ->
    (NT, 128) int32. launch: (group, cols) from sw_launch. The FFI
    target must be registered (register()) before this is lowered for
    the GPU."""
    group, cols = launch
    out = jax.ShapeDtypeStruct((sx.shape[0], LANES), jnp.int32)
    return jax.ffi.ffi_call("gx_sw_scores", out)(
        sx, sy, nx, ny, group=np.int32(group), cols=np.int32(cols),
        match=np.int32(cfg.match), mismatch=np.int32(cfg.mismatch),
        gap_open=np.int32(cfg.gap_open),
        gap_extend=np.int32(cfg.gap_extend))


@functools.partial(jax.jit, static_argnames=("launch", "mm_div", "bitmask"))
def pairhmm_tiles(rchar, qr, mmv, gapm, qi, qd, qg, hap, rl, hl, *,
                  launch: tuple[int, int], mm_div: float = 1.0,
                  bitmask: bool = False):
    """PairHMM log10 likelihoods of one bucket: rchar (NT, NXs, 128) int8,
    six (NT, NXs, 128) f32 quality tables, hap (NT, NDs, 128) int8
    reversed stream, rl/hl (NT*128,) int32 -> (NT, 128) f32, relative to
    the reference's scaling constant (as phmm_forward_dense). launch:
    (group, cols) from pairhmm_launch."""
    group, cols = launch
    out = jax.ShapeDtypeStruct((rchar.shape[0], LANES), jnp.float32)
    return jax.ffi.ffi_call("gx_pairhmm", out)(
        rchar, qr, mmv, gapm, qi, qd, qg, hap, rl, hl,
        group=np.int32(group), cols=np.int32(cols),
        bitmask=np.int32(bitmask), inv_mm_div=np.float32(1.0 / mm_div))


# ---------------------------------------------------------------------------
# Host emulation (CPU tests)
# ---------------------------------------------------------------------------


def _host():
    global _host_lib
    with _lock:
        if _host_lib is None:
            lib = ctypes.CDLL(build_host())
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            lib.gx_host_sw_tiles.restype = ctypes.c_int
            lib.gx_host_sw_tiles.argtypes = [
                i8p, i8p, i32p, i32p, i32p, i64, i32, i32, i32, i32,
                i32, i32, i32, i32]
            lib.gx_host_phmm_tiles.restype = ctypes.c_int
            lib.gx_host_phmm_tiles.argtypes = [
                i8p, f32p, f32p, f32p, f32p, f32p, f32p, i8p, i32p, i32p,
                f32p, i64, i32, i32, i32, i32, i32, ctypes.c_float]
            _host_lib = lib
        return _host_lib


def _c(a, dtype):
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def host_sw_tiles(sx, sy, nx, ny, *, cfg: SWConfig = SWConfig(),
                  launch: tuple[int, int]) -> np.ndarray:
    """sw_tiles run by the host emulation of the kernel's schedule."""
    group, cols = launch
    sx, sy = _c(sx, np.int8), _c(sy, np.int8)
    out = np.zeros((sx.shape[0], LANES), np.int32)
    rc = _host().gx_host_sw_tiles(
        sx, sy, _c(nx, np.int32), _c(ny, np.int32), out, sx.shape[0],
        sx.shape[1], sy.shape[1], group, cols, cfg.match, cfg.mismatch,
        cfg.gap_open, cfg.gap_extend)
    if rc:
        raise ValueError(f"cols={cols} is not instantiated")
    return out


def host_pairhmm_tiles(rchar, qr, mmv, gapm, qi, qd, qg, hap, rl, hl, *,
                       launch: tuple[int, int], mm_div: float = 1.0,
                       bitmask: bool = False) -> np.ndarray:
    """pairhmm_tiles run by the host emulation of the kernel's schedule."""
    group, cols = launch
    rchar, hap = _c(rchar, np.int8), _c(hap, np.int8)
    q = [_c(a, np.float32) for a in (qr, mmv, gapm, qi, qd, qg)]
    out = np.zeros((rchar.shape[0], LANES), np.float32)
    rc = _host().gx_host_phmm_tiles(
        rchar, *q, hap, _c(rl, np.int32), _c(hl, np.int32), out,
        rchar.shape[0], rchar.shape[1], hap.shape[1], group, cols,
        int(bitmask), np.float32(1.0 / mm_div))
    if rc:
        raise ValueError(f"cols={cols} is not instantiated")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m genomax.kernels.cuda",
        description="build the CUDA kernel library and the host emulation")
    ap.add_argument("--host", action="store_true",
                    help="build only the host emulation (no nvcc needed)")
    ap.add_argument("--force", action="store_true", help="rebuild")
    args = ap.parse_args(argv)
    print(build_host(force=args.force))
    if not args.host:
        print(build_cuda(force=args.force))
    return 0


if __name__ == "__main__":
    sys.exit(main())
