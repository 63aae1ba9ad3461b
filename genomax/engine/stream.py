"""Streaming driver: chunked scoring with host packing overlapped
against device execution.

The reference host uploads sequences string-by-string inside its timing
loop (smithWaterman.cu:421-454, pairHMM.cu:534-611). SURVEY.md §2.4
plans the replacement: a packed, double-buffered input pipeline. The Engine already packs densely and dispatches buckets
asynchronously; this module adds the PIPELINE across chunks of a large
workload:

    chunk i:    [pack (host, worker thread)] -> [dispatch] -> [fence]
    chunk i+1:        [pack (overlapped with chunk i's device time)] ...

Packing runs in a worker thread (the hot fill loops are native C or
numpy, which release the GIL), one chunk ahead of the device; jit
dispatch and fencing stay on the caller's thread — only numpy work
crosses threads, so there is no concurrent use of JAX from two threads.
Peak host memory is bounded by ~2 chunks of packed buffers instead of
the whole workload.

Memory/latency knob: chunk_pairs. Big chunks amortize per-dispatch
cost and kernel-shape reuse; small chunks bound memory and
time-to-first-result. The default suits the 25k-pair
reference workloads.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from genomax.engine.executor import (RunStats, _run_buckets,
                                     phmm_bucket_stats, sw_bucket_stats,
                                     unpack_scores)
from genomax.pack.bucketing import pack_sw_pairs


def sw_scores_stream(engine, pairs, chunk_pairs: int = 65536) -> np.ndarray:
    """Engine.sw_scores over chunks with pack/execute overlap. Returns
    scores in input order; engine.last_stats aggregates all chunks
    (pack_s is the NON-overlapped pack time actually spent waiting)."""
    if chunk_pairs < 1:
        raise ValueError(f"chunk_pairs must be >= 1, got {chunk_pairs}")
    n = len(pairs)
    out = np.zeros(n, np.int32)
    stats = RunStats(n_jobs=n)
    spans = [(s, min(s + chunk_pairs, n)) for s in range(0, n, chunk_pairs)]
    if not spans:  # empty workload: match Engine.sw_scores([])
        engine.last_stats = stats
        return out

    def prep(span):
        s, e = span
        chunk = pairs[s:e]
        off = engine._sw_offload_mask(chunk)
        buckets = pack_sw_pairs(
            chunk, job_mask=None if off is None else ~off,
            stream_band=engine._stream_band(),
        )
        return chunk, off, buckets

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prep, spans[0])
        for i, (s, e) in enumerate(spans):
            t0 = time.perf_counter()
            chunk, off, buckets = fut.result()
            stats.pack_s += time.perf_counter() - t0  # wait time only
            if i + 1 < len(spans):
                fut = pool.submit(prep, spans[i + 1])
            stats.buckets += len(buckets)
            sw_bucket_stats(stats, buckets)
            t1 = time.perf_counter()
            results = _run_buckets("sw-stream", buckets, engine._sw_bucket)
            # exec_s strictly around the device dispatch+fence, matching
            # Engine.sw_scores — unpack/offload time would otherwise
            # deflate gcups under --chunk for identical device work
            stats.exec_s += time.perf_counter() - t1
            part = unpack_scores(buckets, results, len(chunk), np.int32)
            engine._sw_offload_post(chunk, part, off, stats)
            out[s:e] = part
    engine.last_stats = stats
    return out


def pairhmm_stream(engine, batches, chunk_batches: int = 64) -> np.ndarray:
    """Engine.pairhmm over chunks of batches with pack/execute overlap.
    Reference output order (batches in file order, read-major within
    batch) is preserved: chunks are contiguous batch runs."""
    if chunk_batches < 1:
        raise ValueError(f"chunk_batches must be >= 1, got {chunk_batches}")
    spans = [
        batches[s : s + chunk_batches]
        for s in range(0, len(batches), chunk_batches)
    ]
    stats = RunStats()
    outs = []
    if not spans:  # empty workload: match Engine.pairhmm([])
        engine.last_stats = stats
        return np.zeros(0, np.float32)

    def prep(chunk):
        off = engine._phmm_offload_mask(chunk)
        buckets, n = engine._phmm_pack(chunk, off)
        return chunk, off, buckets, n

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prep, spans[0])
        for i, _ in enumerate(spans):
            t0 = time.perf_counter()
            chunk, off, buckets, n = fut.result()
            stats.pack_s += time.perf_counter() - t0
            if i + 1 < len(spans):
                fut = pool.submit(prep, spans[i + 1])
            stats.n_jobs += n
            stats.buckets += len(buckets)
            phmm_bucket_stats(stats, buckets)
            t1 = time.perf_counter()
            results = _run_buckets(
                "pairhmm-stream", buckets, engine._phmm_bucket)
            stats.exec_s += time.perf_counter() - t1  # see sw_scores_stream
            part = unpack_scores(buckets, results, n, np.float32)
            part, native_done = engine._phmm_offload_post(
                chunk, part, off, stats)
            part = engine._phmm_fallback(chunk, part, stats,
                                         skip=native_done)
            outs.append(part)
    engine.last_stats = stats
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)
