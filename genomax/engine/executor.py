"""Per-chip execution engine.

Replaces the reference host mains (smithWaterman.cu:371-499,
pairHMM.cu:370-654): parse → pack/bucket → dispatch kernels → restore
output order. Kernel launches are jit-compiled once per bucket shape and
cached by JAX; each bucket ships as a few dense arrays instead of the
reference's per-string cudaMemcpy loop.

Backends (EngineConfig.backend):
  * "cuda" — the Hopper kernels (kernels/cuda.py), fed through the
    transfer ladder (nibble codes, stream band, factored PairHMM).
  * "lax"  — the pure-JAX wavefront twins (kernels/wavefront.py), the
    reference path; runs on any JAX backend.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from genomax.config import EngineConfig, PairHMMConfig, SWConfig
from genomax.pack.bucketing import (
    pack_pairhmm_batches,
    pack_sw_pairs,
    unpack_scores,
)


class EngineError(RuntimeError):
    """Structured engine failure: which stage and bucket failed.

    The reference reads back a per-kernel error flag and never checks it
    (smithWaterman.cu:474) and aborts the process on API errors (CHECK
    macro, :19-29); here failures carry their stage, bucket and shape."""

    def __init__(self, stage: str, bucket: int, shape, cause: Exception):
        super().__init__(
            f"{stage} failed on bucket {bucket} (shape {shape}): {cause!r}"
        )
        self.stage = stage
        self.bucket = bucket
        self.cause = cause


def _run_buckets(stage, buckets, dispatch):
    """Dispatch all buckets asynchronously, then fetch each result (the
    host copy is the fence). Any failure, at dispatch (trace, compile) or
    at the fetch (device), surfaces as an EngineError."""

    def _shape(b):
        a = getattr(b, "sx", None)
        if a is None:
            a = getattr(b, "rchar", None)
        return None if a is None else a.shape

    def _guard(i, b, fn):
        try:
            return fn()
        except Exception as e:
            raise EngineError(stage, i, _shape(b), e) from e

    pending = [(i, b, _guard(i, b, lambda: dispatch(b)))
               for i, b in enumerate(buckets)]
    return [_guard(i, b, lambda: np.asarray(r)) for i, b, r in pending]


@dataclasses.dataclass
class RunStats:
    """Observability: per-run metrics (pack/compile/execute split, cell
    counts, padding efficiency). The reference only ever reports a single
    wall-clock 'elapsed' (antidiagonalSmithWaterman.c:351-352)."""

    n_jobs: int = 0
    dp_cells: int = 0  # true interior DP cells
    padded_cells: int = 0  # sublanes * diagonals actually swept
    pack_s: float = 0.0
    exec_s: float = 0.0
    buckets: int = 0
    fallback_jobs: int = 0  # PairHMM pairs recomputed in native fp64
    offloaded_jobs: int = 0  # oversized pairs routed to the native model

    @property
    def gcups(self) -> float:
        return self.dp_cells / max(self.exec_s, 1e-12) / 1e9

    @property
    def padding_efficiency(self) -> float:
        return self.dp_cells / max(self.padded_cells, 1)

    def as_dict(self) -> dict:
        return {
            "n_jobs": self.n_jobs,
            "dp_cells": self.dp_cells,
            "pack_s": round(self.pack_s, 6),
            "exec_s": round(self.exec_s, 6),
            "gcups": round(self.gcups, 3),
            "padding_efficiency": round(self.padding_efficiency, 4),
            "buckets": self.buckets,
            "fallback_jobs": self.fallback_jobs,
            "offloaded_jobs": self.offloaded_jobs,
        }


def _make_dense_jits():
    import jax as _jax

    from genomax.kernels.wavefront import phmm_forward_dense, sw_forward_dense

    sw = _jax.jit(sw_forward_dense, static_argnames=("n_diags", "cfg"))
    ph = _jax.jit(phmm_forward_dense,
                  static_argnames=("n_diags", "rescale_period", "mm_div",
                                   "bitmask"))
    return sw, ph


_DENSE_JITS = None


def _sw_dense_jit(*args, **kw):
    global _DENSE_JITS
    if _DENSE_JITS is None:
        _DENSE_JITS = _make_dense_jits()
    return _DENSE_JITS[0](*args, **kw)


def _phmm_dense_jit(*args, **kw):
    global _DENSE_JITS
    if _DENSE_JITS is None:
        _DENSE_JITS = _make_dense_jits()
    return _DENSE_JITS[1](*args, **kw)


def sw_bucket_stats(stats, buckets):
    """Accumulate dp/padded cell counts for SW buckets (shared by the
    one-shot engine and the streaming driver)."""
    for b in buckets:
        stats.dp_cells += int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
        stats.padded_cells += int(b.sx.shape[1]) * 128 * int(
            b.ndiag_tile.astype(np.int64).sum()
        )


def phmm_bucket_stats(stats, buckets):
    for b in buckets:
        stats.dp_cells += int((b.rl.astype(np.int64) * b.hl).sum())
        stats.padded_cells += int(b.nxs) * 128 * int(
            b.ndiag_tile.astype(np.int64).sum()
        )


def flatten_tiles(x):
    """(NT, R, 128) sublane-major tiles -> (R, NT*128) dense batch (the
    lax twin's layout: positions on axis 0, all pairs on axis 1).
    int8 code arrays widen to the kernels' int32 here."""
    import jax.numpy as jnp

    x = jnp.asarray(x)
    if x.dtype == jnp.int8:
        x = x.astype(jnp.int32)
    return jnp.moveaxis(x, 0, 1).reshape(x.shape[1], -1)


class Engine:
    def __init__(
        self,
        cfg: EngineConfig = EngineConfig(),
        sw_cfg: SWConfig = SWConfig(),
        phmm_cfg: PairHMMConfig = PairHMMConfig(),
    ):
        import genomax

        genomax.setup_compilation_cache()
        self.cfg = cfg
        self.sw_cfg = sw_cfg.validate()
        self.phmm_cfg = phmm_cfg
        self.backend = cfg.resolve_backend()
        if self.backend == "cuda":
            from genomax.kernels import cuda

            cuda.register()
        self.last_stats: RunStats | None = None

    # -- Smith-Waterman ----------------------------------------------------

    def _stream_band(self) -> bool:
        """THE stream-band gate (pack.bucketing.StreamBand), shared by
        the local and sharded engines so the policy cannot drift: the
        device backend rebuilds the stream on device; the lax/native
        paths want full host buffers."""
        return self.backend == "cuda" and self.cfg.stream_band_transfer

    def _sw_bucket(self, b):
        import jax.numpy as jnp

        if self.backend == "cuda":
            from genomax.kernels import cuda
            from genomax.pack.nibble import make_shipper, ship_stream

            # Nibble-compressed transfer (pack/nibble.py): remap the
            # bucket alphabet to 4-bit codes and ship two rows per byte,
            # expanding bit-exactly on device. One shared LUT per bucket
            # (x and stream codes must remap identically); raw bytes when
            # the alphabet exceeds 14 symbols.
            ship = jnp.asarray
            if self.cfg.nibble_transfer:
                from genomax.pack.nibble import build_code_lut, stream_bytes

                ship = make_shipper(
                    jnp.asarray, lut=build_code_lut(b.sx, stream_bytes(b.sy)))
            return cuda.sw_tiles(
                ship(b.sx), ship_stream(ship, b.sy), jnp.asarray(b.nx),
                jnp.asarray(b.ny), cfg=self.sw_cfg, launch=cuda.sw_launch(b))

        return _sw_dense_jit(
            flatten_tiles(b.sx),
            flatten_tiles(b.sy),
            jnp.asarray(b.nx),
            jnp.asarray(b.ny),
            n_diags=-(-b.max_diags // 32) * 32,  # round up: fewer recompiles
            cfg=self.sw_cfg,
        )

    def _max_len(self, reach: int) -> int:
        """Padded sublane bound for the device: cfg.max_device_len, capped
        by the CUDA kernel's reach (x columns / read rows, plus the two
        pad rows the bound counts)."""
        if self.backend == "cuda":
            return min(self.cfg.max_device_len, reach + 2)
        return self.cfg.max_device_len

    def _sw_offload_mask(self, pairs):
        """True = too big for the device path; run natively."""
        from genomax.kernels.cuda import SW_MAX_X

        L, D = self._max_len(SW_MAX_X), self.cfg.max_device_diags
        m = np.array(
            [len(p.sx) + 2 > L or len(p.sx) + len(p.sy) + 1 > D for p in pairs]
        )
        return m if m.any() else None

    def sw_scores(self, pairs) -> np.ndarray:
        """Scores for SWPair jobs, in input order."""
        stats = RunStats(n_jobs=len(pairs))
        off = self._sw_offload_mask(pairs)
        t0 = time.perf_counter()
        buckets = pack_sw_pairs(
            pairs, job_mask=None if off is None else ~off,
            stream_band=self._stream_band(),
        )
        stats.pack_s = time.perf_counter() - t0
        stats.buckets = len(buckets)
        sw_bucket_stats(stats, buckets)
        t0 = time.perf_counter()
        # Dispatch all buckets asynchronously, fence once (latency
        # overlaps device execution); diagnostics in _run_buckets.
        results = _run_buckets("sw", buckets, self._sw_bucket)
        stats.exec_s = time.perf_counter() - t0
        out = unpack_scores(buckets, results, len(pairs), np.int32)
        self._sw_offload_post(pairs, out, off, stats)
        self.last_stats = stats
        return out

    def _sw_offload_post(self, pairs, out, off, stats):
        """Score the offloaded (too big for the device path) pairs with the
        exact native model (the reference caps at 1kbp; genomax takes any
        length). Shared by Engine and ShardedEngine so every execution
        path returns one consistent answer per input."""
        if off is None:
            return
        from genomax import native

        idx = np.nonzero(off)[0]
        out[idx] = native.sw_scores_native([pairs[i] for i in idx],
                                           self.sw_cfg)
        stats.offloaded_jobs += len(idx)

    def sw_scores_file(self, path: str) -> np.ndarray:
        from genomax.io.formats import parse_sw_file

        return self.sw_scores(parse_sw_file(path))

    # -- PairHMM -----------------------------------------------------------

    def _phmm_bucket(self, b):
        import jax.numpy as jnp

        if self.backend == "cuda":
            from genomax.kernels import cuda
            from genomax.pack.expand import expand_byte_quals, expand_factored
            from genomax.pack.nibble import make_shipper

            if b.rchar_u is not None:
                # factored pack: ship unique reads/haps + gather indices,
                # rebuild the job tiles on device.
                rchar, *quals, hap = expand_factored(
                    jnp.asarray(b.rchar_u), jnp.asarray(b.qb_u),
                    jnp.asarray(b.hap_u), jnp.asarray(b.ridx),
                    jnp.asarray(b.hidx),
                    float(self.phmm_cfg.phred_offset),
                )
            else:
                # byte_quals pack: raw phred bytes, expanded on device.
                # Match-bitmask codes are 4-bit already, so rchar and the
                # hap stream nibble-pack with no remap (pack/nibble.py).
                quals = expand_byte_quals(
                    jnp.asarray(b.qb), float(self.phmm_cfg.phred_offset))
                ship = make_shipper(
                    jnp.asarray,
                    four_bit=b.bitmask_codes and self.cfg.nibble_transfer,
                )
                rchar, hap = ship(b.rchar), ship(b.hap)
            return cuda.pairhmm_tiles(
                rchar, *quals, hap, jnp.asarray(b.rl), jnp.asarray(b.hl),
                launch=cuda.pairhmm_launch(b), mm_div=self.phmm_cfg.mm_div,
                bitmask=b.bitmask_codes)

        return _phmm_dense_jit(
            flatten_tiles(b.rchar),
            flatten_tiles(b.qr),
            flatten_tiles(b.mmv),
            flatten_tiles(b.gapm),
            flatten_tiles(b.qi),
            flatten_tiles(b.qd),
            flatten_tiles(b.qg),
            flatten_tiles(b.hap),
            jnp.asarray(b.rl),
            jnp.asarray(b.hl),
            n_diags=-(-b.max_diags // self.cfg.rescale_period)
            * self.cfg.rescale_period,
            rescale_period=self.cfg.rescale_period,
            mm_div=self.phmm_cfg.mm_div,
            bitmask=b.bitmask_codes,
        )

    def _phmm_pack(self, batches, off):
        """Pack for this engine's backend: the device backend takes raw
        quality bytes (and the factored cross-product when enabled), the
        lax path the host-decoded fp32 tables."""
        device = self.backend == "cuda"
        return pack_pairhmm_batches(
            batches,
            self.phmm_cfg.phred_offset,
            job_mask=None if off is None else ~off,
            byte_quals=device,
            factored=device and self.cfg.factored_transfer,
            bitmask_codes=True,
        )

    def _phmm_offload_mask(self, batches):
        """True = too big for the device path; run natively."""
        from genomax.kernels.cuda import PHMM_MAX_READ

        L = min(self.cfg.max_device_len // 2, self._max_len(PHMM_MAX_READ))
        D = self.cfg.max_device_diags // 2
        off = []
        for b in batches:
            for rd in b.reads:
                for hp in b.haplotypes:
                    off.append(
                        len(rd.bases) + 2 > L
                        or len(rd.bases) + len(hp) + 1 > D
                    )
        return np.array(off) if any(off) else None

    def pairhmm(self, batches) -> np.ndarray:
        """log10 likelihoods for all read×haplotype pairs across batches,
        in reference output order (batches in file order, read-major
        within batch)."""
        stats = RunStats()
        off = self._phmm_offload_mask(batches)
        t0 = time.perf_counter()
        buckets, n = self._phmm_pack(batches, off)
        stats.pack_s = time.perf_counter() - t0
        stats.n_jobs = n
        stats.buckets = len(buckets)
        phmm_bucket_stats(stats, buckets)
        t0 = time.perf_counter()
        results = _run_buckets("pairhmm", buckets, self._phmm_bucket)
        stats.exec_s = time.perf_counter() - t0
        out = unpack_scores(buckets, results, n, np.float32)
        out, native_done = self._phmm_offload_post(batches, out, off, stats)
        out = self._phmm_fallback(batches, out, stats, skip=native_done)
        self.last_stats = stats
        return out

    def _phmm_offload_post(self, batches, out, off, stats):
        """Score the offloaded (too big for the device path) jobs with the
        exact native fp64 model. Returns (out, native_done), where
        native_done marks the jobs already exact (excluded from the
        deep-negative fallback)."""
        if off is None:
            return out, None
        idx = np.nonzero(off)[0]
        stats.offloaded_jobs += len(idx)
        out = self._phmm_native_subset(batches, out, idx)
        native_done = np.zeros(len(out), bool)
        native_done[idx] = True
        return out, native_done

    def _phmm_native_subset(self, batches, out, idx):
        """Recompute the given flat job indices through the native fp64
        model and scatter into out (promoting to f64)."""
        from genomax import native
        from genomax.io.formats import PairHMMBatch

        want = set(int(i) for i in idx)
        jobs = []
        j = 0
        for b in batches:
            for rd in b.reads:
                for hp in b.haplotypes:
                    if j in want:
                        jobs.append(PairHMMBatch(reads=[rd], haplotypes=[hp]))
                    j += 1
        exact = native.pairhmm_native(jobs, self.phmm_cfg.phred_offset,
                                      self.phmm_cfg.gatk_emission)
        out = out.astype(np.float64)
        out[np.asarray(sorted(want), dtype=np.int64)] = exact
        return out

    def _phmm_fallback(self, batches, out, stats, skip=None):
        """Recompute deep-negative / non-finite results in native fp64
        (the fp32 fast path's design range is bounded by the per-diagonal
        dynamic span; see kernels/wavefront.py). Mirrors GATK/GKL's
        fp32-with-fp64-fallback production structure."""
        thr = self.cfg.phmm_fallback_threshold
        if thr is None:
            return out
        mask = ~np.isfinite(out) | (out < thr)
        if skip is not None:
            mask &= ~skip  # offloaded jobs are already exact fp64
        if not mask.any():
            return out
        # No native.available() gate: pairhmm_native degrades to the
        # pure-python fp64 oracle on toolchain-less hosts, which is slow
        # but CORRECT — skipping the fallback would return fp32 results
        # wrong by up to ~9 log10 units and make `genomax soak` fail
        # spuriously on such hosts.
        stats.fallback_jobs += int(mask.sum())
        return self._phmm_native_subset(batches, out, np.nonzero(mask)[0])

    def pairhmm_file(self, path: str) -> np.ndarray:
        from genomax.io.formats import parse_pairhmm_file

        return self.pairhmm(parse_pairhmm_file(path))

    # -- Streaming (chunked, pack/execute overlapped) ---------------------

    def sw_scores_stream(self, pairs, chunk_pairs: int = 65536) -> np.ndarray:
        """sw_scores over chunks with host packing overlapped against
        device execution (engine/stream.py) — bounded host memory and
        pipeline throughput on large workloads."""
        from genomax.engine.stream import sw_scores_stream

        return sw_scores_stream(self, pairs, chunk_pairs)

    def pairhmm_stream(self, batches, chunk_batches: int = 64) -> np.ndarray:
        """pairhmm over chunks of batches with pack/execute overlap."""
        from genomax.engine.stream import pairhmm_stream

        return pairhmm_stream(self, batches, chunk_batches)
