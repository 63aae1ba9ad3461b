"""genomax — a pairwise-alignment scoring engine on JAX.

A from-scratch JAX framework with the capabilities of the reference GPU
project (Smith-Waterman affine-gap score-only alignment and the PairHMM
forward algorithm; see SURVEY.md):

  * anti-diagonal wavefront DP for batches of pairs: a plain-JAX twin
    (kernels/wavefront.py, the reference path) and Hopper kernels in CUDA
    called through jax.ffi (kernels/cuda.py, kernels/csrc/);
  * ragged inputs packed/bucketed into dense 128-pair tiles;
  * data parallelism over a device mesh via ``shard_map`` with
    all-gathered scores;
  * a native C++ fp64 golden model + parser for differential testing
    (mirrors the role of the reference's C binaries).

Layout (SURVEY.md §7):
    io/       file formats, phred decode, input generator
    pack/     ragged-length bucketing, dense packing, transfer forms
    kernels/  CUDA kernels + pure-JAX wavefront + numpy oracle
    engine/   per-device executor (bucket dispatch, jit cache)
    dist/     device mesh, sharded scoring, collectives
    cli/      drop-in command line (sw / pairhmm / bench / parity)
    native/   C++ golden model and fast parser (ctypes)
"""

import os

__version__ = "0.1.0"

from genomax.config import SWConfig, PairHMMConfig, EngineConfig  # noqa: F401

_CACHE_SET_UP = False

# The checkout's own compile cache directory (listed in .gitignore).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compilation_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache (idempotent). JAX reads
    $JAX_COMPILATION_CACHE_DIR itself; only when it is unset does this set
    the directory, to DEFAULT_CACHE_DIR. Called by the engines, the CLI
    and bench.py."""
    global _CACHE_SET_UP
    if _CACHE_SET_UP:
        return
    _CACHE_SET_UP = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def __getattr__(name):
    # Lazy: keep `import genomax` light (Engine pulls in jax).
    if name == "Engine":
        from genomax.engine.executor import Engine

        return Engine
    raise AttributeError(name)
