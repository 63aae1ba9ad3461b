"""Smoke test of genomax's scoring path on an NVIDIA GPU.

Runs the main path through the normal entry points (Engine, ShardedEngine)
in one process, at the reference's own benchmark sizes, with the CUDA
kernels compiled for the card and the plain-JAX ``lax`` path beside them:

  1. card check (platform must be ``gpu``; nvidia-smi name and power limit)
  2. build of the CUDA kernel library and the native fp64 golden library
  3. SW: the golden files exactly; 25,000 seeded 512bp pairs and 25,000
     64bp pairs, kernel bit-identical to lax and (1,000 pairs) to native;
     warm end-to-end times of both backends
  4. PairHMM: 10s.in within 1e-4 log10 of the reference output; 65,536
     seeded 151bp x 300bp read x haplotype pairs, kernel within 1e-4 of
     lax and (1,000 pairs) of native; warm times of both backends
  5. long pairs (2-5 kbp SW, 600bp reads) equal to native via offload
  6. peak device memory, compile count and compile time

``--devices 4`` runs only the multi-device phase: ShardedEngine over four
cards on the SW 25k x 512bp and PairHMM 65k inputs, against the one-card
Engine in the same process.

Usage (from the repository root): python chip_smoke.py [--devices 4]
Any failed check exits non-zero. The last line printed is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
PHMM_TOL = 1e-4  # log10; see the PairHMM phase for the reason
WARM_RUNS = 5
SEED = 20261016


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def median_time(fn) -> float:
    """Median wall time of WARM_RUNS calls (results fetched to the host
    inside fn); the caller has already run fn once to compile."""
    ts = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def sw_pairs(n: int, length: int, seed: int):
    from genomax.io.formats import SWPair
    from genomax.io.generator import random_dna

    rng = np.random.default_rng(seed)
    # the reference generator's trailing-'\n' byte is part of each sequence
    return [SWPair(sx=random_dna(rng, length) + b"\n",
                   sy=random_dna(rng, length) + b"\n") for _ in range(n)]


def phmm_batch():
    from genomax.io.generator import generate_pairhmm_batch

    # HaplotypeCaller-shaped: reads are error-perturbed substrings of the
    # candidate haplotypes (8192 reads x 8 haplotypes = 65,536 pairs)
    return generate_pairhmm_batch(8192, 8, read_len=151, hap_len=300,
                                  seed=SEED, from_haps=True)


def rate_line(what, cells, t_cuda, t_lax, card) -> str:
    return (f"{what}: cuda {t_cuda * 1e3:.3f} ms = "
            f"{cells / t_cuda / 1e9:.3f} GCUPS | lax {t_lax * 1e3:.3f} ms = "
            f"{cells / t_lax / 1e9:.3f} GCUPS | speedup "
            f"{t_lax / t_cuda:.2f}x | median of {WARM_RUNS} warm end-to-end "
            f"runs | {card}")


def timed_pair(run_cuda, run_lax):
    """Compile both, then time both; returns (t_cuda, t_lax, out_cuda,
    out_lax, compile seconds)."""
    t0 = time.perf_counter()
    out_c = run_cuda()
    out_l = run_lax()
    first = time.perf_counter() - t0
    return median_time(run_cuda), median_time(run_lax), out_c, out_l, first


def kernel_line(what, buckets, run_kernel, run_lax, cells, card) -> str:
    """Device time of the kernel alone vs the lax twin alone: inputs
    already on the card in each one's layout, median of WARM_RUNS calls
    ending in block_until_ready after a compiling call, summed over the
    buckets."""
    import jax

    t_k = t_l = 0.0
    for b in buckets:
        for run in (run_kernel, run_lax):
            jax.block_until_ready(run(b))
        t_k += median_time(lambda: jax.block_until_ready(run_kernel(b)))
        t_l += median_time(lambda: jax.block_until_ready(run_lax(b)))
    return (f"{what} kernel only: cuda {t_k * 1e3:.3f} ms = "
            f"{cells / t_k / 1e9:.3f} GCUPS | lax twin {t_l * 1e3:.3f} ms = "
            f"{cells / t_l / 1e9:.3f} GCUPS | {card}")


def sw_kernel_line(pairs, cfg, card) -> str:
    import jax

    from genomax.engine.executor import _sw_dense_jit, flatten_tiles
    from genomax.kernels import cuda
    from genomax.pack.bucketing import pack_sw_pairs

    buckets = pack_sw_pairs(pairs)
    dev = {id(b): [jax.device_put(a) for a in (b.sx, b.sy, b.nx, b.ny)]
           for b in buckets}
    flat = {k: [flatten_tiles(a[0]), flatten_tiles(a[1]), a[2], a[3]]
            for k, a in dev.items()}

    def run_kernel(b):
        return cuda.sw_tiles(*dev[id(b)], cfg=cfg, launch=cuda.sw_launch(b))

    def run_lax(b):
        return _sw_dense_jit(*flat[id(b)], n_diags=-(-b.max_diags // 32) * 32,
                             cfg=cfg)

    cells = sum(int(((b.nx - 1).astype(np.int64) * (b.ny - 1)).sum())
                for b in buckets)
    return kernel_line(f"SW {len(pairs)} pairs", buckets, run_kernel,
                       run_lax, cells, card)


def phmm_kernel_line(batches, card) -> str:
    import jax

    from genomax.engine.executor import _phmm_dense_jit, flatten_tiles
    from genomax.kernels import cuda
    from genomax.pack.bucketing import pack_pairhmm_batches

    buckets, _ = pack_pairhmm_batches(batches, bitmask_codes=True)
    names = ("rchar", "qr", "mmv", "gapm", "qi", "qd", "qg", "hap", "rl",
             "hl")
    dev = {id(b): [jax.device_put(getattr(b, n)) for n in names]
           for b in buckets}
    flat = {k: [flatten_tiles(x) for x in a[:8]] + a[8:]
            for k, a in dev.items()}

    def run_kernel(b):
        return cuda.pairhmm_tiles(*dev[id(b)], launch=cuda.pairhmm_launch(b),
                                  bitmask=b.bitmask_codes)

    def run_lax(b):
        return _phmm_dense_jit(*flat[id(b)],
                               n_diags=-(-b.max_diags // 32) * 32,
                               rescale_period=32, bitmask=b.bitmask_codes)

    cells = sum(int((b.rl.astype(np.int64) * b.hl).sum()) for b in buckets)
    return kernel_line(f"PairHMM {len(buckets)} buckets", buckets,
                       run_kernel, run_lax, cells, card)


def phase_sw(cuda_eng, lax_eng, card):
    from genomax import native
    from genomax.io.formats import parse_sw_file

    print("== SW", flush=True)
    for name in ("sw_small", "sw_medium", "sw_quirks"):
        pairs = parse_sw_file(os.path.join(GOLDEN, f"{name}.in"))
        with open(os.path.join(GOLDEN, f"{name}.golden.out")) as f:
            want = np.array([int(line.split()[1]) for line in f])
        check(np.array_equal(cuda_eng.sw_scores(pairs), want),
              f"{name}.in: {len(want)} scores equal the golden output")
    for length, seed in ((512, SEED), (64, SEED + 1)):
        pairs = sw_pairs(25_000, length, seed)
        t_c, t_l, got, want, first = timed_pair(
            lambda: cuda_eng.sw_scores(pairs),
            lambda: lax_eng.sw_scores(pairs))
        check(np.array_equal(got, want),
              f"SW 25000x{length}bp: cuda bit-identical to lax")
        nat = native.sw_scores_native(pairs[:1000], cuda_eng.sw_cfg)
        check(np.array_equal(got[:1000], nat),
              f"SW 25000x{length}bp: first 1000 equal native")
        cells = cuda_eng.last_stats.dp_cells
        st = cuda_eng.last_stats
        print(f"  first (compiling) calls, both backends: {first:.2f} s; "
              f"cuda split: pack {st.pack_s * 1e3:.3f} ms, dispatch+fetch "
              f"{st.exec_s * 1e3:.3f} ms", flush=True)
        print("  " + rate_line(f"SW 25000x{length}bp", cells, t_c, t_l,
                               card), flush=True)
        print("  " + sw_kernel_line(pairs, cuda_eng.sw_cfg, card), flush=True)


def phase_pairhmm(cuda_eng, lax_eng, card):
    from genomax import native
    from genomax.io.formats import PairHMMBatch

    print("== PairHMM", flush=True)
    # fp32 on both device paths, with a different operation order (and
    # FMA contraction) in each: results agree with each other and with
    # the fp64 model to ~1e-5 log10; 1e-4 is the repo's parity contract.
    print(f"  tolerance {PHMM_TOL} log10: fp32 with a different operation "
          "order and FMA contraction than the fp64 reference", flush=True)
    want = np.loadtxt(os.path.join(GOLDEN, "10s.golden.out"))
    path = os.path.join(GOLDEN, "10s.in")
    t_c, t_l, got, got_l, _ = timed_pair(
        lambda: cuda_eng.pairhmm_file(path), lambda: lax_eng.pairhmm_file(path))
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    check(err <= PHMM_TOL, f"10s.in: max|err| {err:.3e} vs the reference "
          f"output ({len(want)} pairs, {cuda_eng.last_stats.fallback_jobs} "
          "fp64 fallbacks)")
    err_l = float(np.abs(np.asarray(got_l, np.float64) - want).max())
    check(err_l <= PHMM_TOL, f"10s.in lax: max|err| {err_l:.3e}")
    print("  " + rate_line("PairHMM 10s.in", cuda_eng.last_stats.dp_cells,
                           t_c, t_l, card), flush=True)
    from genomax.io.formats import parse_pairhmm_file

    print("  " + phmm_kernel_line(parse_pairhmm_file(path), card), flush=True)

    batch = phmm_batch()
    t_c, t_l, got, want_l, first = timed_pair(
        lambda: cuda_eng.pairhmm([batch]), lambda: lax_eng.pairhmm([batch]))
    check(bool(np.isfinite(got).all()), "PairHMM 65536: all finite")
    err = float(np.abs(np.asarray(got, np.float64) - want_l).max())
    check(err <= PHMM_TOL, f"PairHMM 65536x151x300: cuda vs lax max|err| "
          f"{err:.3e}")
    sub = PairHMMBatch(reads=batch.reads[:125], haplotypes=batch.haplotypes)
    nat = native.pairhmm_native([sub])
    err_n = float(np.abs(np.asarray(got[:1000], np.float64) - nat).max())
    check(err_n <= PHMM_TOL, f"PairHMM 65536: first 1000 vs native max|err| "
          f"{err_n:.3e}")
    st = cuda_eng.last_stats
    print(f"  first (compiling) calls, both backends: {first:.2f} s; cuda "
          f"split: pack {st.pack_s * 1e3:.3f} ms, dispatch+fetch "
          f"{st.exec_s * 1e3:.3f} ms, fp64 fallbacks {st.fallback_jobs}",
          flush=True)
    print("  " + rate_line("PairHMM 65536x151x300", st.dp_cells, t_c, t_l,
                           card), flush=True)
    print("  " + phmm_kernel_line([batch], card), flush=True)


def phase_long(cuda_eng):
    from genomax import native
    from genomax.io.formats import PairHMMBatch, SWPair
    from genomax.io.generator import generate_pairhmm_batch, random_dna

    print("== long pairs (native offload)", flush=True)
    rng = np.random.default_rng(SEED + 2)
    pairs = [SWPair(sx=random_dna(rng, int(n)), sy=random_dna(rng, int(m)))
             for n, m in ((2000, 2100), (3500, 3000), (5000, 4800))]
    x = random_dna(rng, 2500)
    pairs.append(SWPair(sx=x, sy=x[:1200] + random_dna(rng, 300) + x))
    pairs += sw_pairs(5, 100, SEED + 3)  # short ones stay on the card
    got = cuda_eng.sw_scores(pairs)
    check(np.array_equal(got, native.sw_scores_native(pairs)),
          "SW 2-5 kbp pairs equal native")
    check(cuda_eng.last_stats.offloaded_jobs == 4,
          f"SW offloaded_jobs = {cuda_eng.last_stats.offloaded_jobs}")
    long_b = generate_pairhmm_batch(3, 2, read_len=600, hap_len=700,
                                    seed=SEED, from_haps=True)
    short_b = generate_pairhmm_batch(4, 2, read_len=100, hap_len=150,
                                     seed=SEED + 1, from_haps=True)
    got = cuda_eng.pairhmm([long_b, short_b])
    want = native.pairhmm_native([long_b, short_b])
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    check(err <= PHMM_TOL, f"600bp reads: max|err| {err:.3e} vs native")
    check(cuda_eng.last_stats.offloaded_jobs == 6,
          f"PairHMM offloaded_jobs = {cuda_eng.last_stats.offloaded_jobs}")


def phase_devices(n, card):
    import jax

    from genomax.config import EngineConfig
    from genomax.dist.engine import ShardedEngine
    from genomax.dist.mesh import make_mesh
    from genomax.engine.executor import Engine

    print(f"== ShardedEngine on {n} devices vs the one-card Engine",
          flush=True)
    mesh = make_mesh(n)
    print(f"  mesh: {[d.id for d in mesh.devices.flat]}", flush=True)
    dist = ShardedEngine(mesh, EngineConfig(backend="cuda"))
    one = Engine(EngineConfig(backend="cuda"))
    pairs = sw_pairs(25_000, 512, SEED)
    t_d, t_1, got, want, first = timed_pair(
        lambda: dist.sw_scores(pairs), lambda: one.sw_scores(pairs))
    check(np.array_equal(got, want),
          f"SW 25000x512bp: {n}-device ShardedEngine equals one card")
    cells = one.last_stats.dp_cells
    print(f"  SW 25000x512bp: {n} devices {t_d * 1e3:.3f} ms = "
          f"{cells / t_d / 1e9:.3f} GCUPS | 1 device {t_1 * 1e3:.3f} ms = "
          f"{cells / t_1 / 1e9:.3f} GCUPS | {card} x{n}", flush=True)
    batch = phmm_batch()
    t_d, t_1, got, want, first = timed_pair(
        lambda: dist.pairhmm([batch]), lambda: one.pairhmm([batch]))
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    check(err <= PHMM_TOL, f"PairHMM 65536: {n}-device vs one card max|err| "
          f"{err:.3e}")
    cells = one.last_stats.dp_cells
    print(f"  PairHMM 65536x151x300: {n} devices {t_d * 1e3:.3f} ms = "
          f"{cells / t_d / 1e9:.3f} GCUPS | 1 device {t_1 * 1e3:.3f} ms = "
          f"{cells / t_1 / 1e9:.3f} GCUPS | {card} x{n}", flush=True)
    return jax.devices()[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the ShardedEngine phase on 4 cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import genomax
    except ImportError:
        print("chip_smoke: the genomax package is not next to this script",
              file=sys.stderr)
        return 2
    import jax

    compiles = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, secs, **kw: compiles.append(secs)
        if event.endswith("backend_compile_duration") else None)

    # 1. card check
    devices = jax.devices()
    print(f"jax {jax.__version__}; devices {devices}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"chip_smoke: --devices {args.devices} but JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    genomax.setup_compilation_cache()
    print(f"compile cache: {genomax.compilation_cache_dir()}", flush=True)

    # 2. build (set-up time)
    from genomax import native
    from genomax.kernels import cuda

    t0 = time.perf_counter()
    cuda.build_cuda()
    print(f"setup: CUDA kernel library {cuda.CUDA_LIB} ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    native.build()
    check(native.load() is not None, "native golden library loads")
    print(f"setup: native golden library ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine

    try:
        if args.devices > 1:
            used = phase_devices(args.devices, card)
        else:
            cuda_eng = Engine(EngineConfig(backend="cuda"))
            lax_eng = Engine(EngineConfig(backend="lax"))
            check(cuda_eng.backend == "cuda", "auto-registered CUDA backend")
            phase_sw(cuda_eng, lax_eng, card)
            phase_pairhmm(cuda_eng, lax_eng, card)
            phase_long(cuda_eng)
            used = devices[:1]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # 6. memory and compiles
    for d in used:
        peak = d.memory_stats().get("peak_bytes_in_use", 0)
        print(f"device {d.id}: peak_bytes_in_use {peak} "
              f"({peak / 2**30:.3f} GiB)", flush=True)
    print(f"XLA compiles: {len(compiles)}, {sum(compiles):.2f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": used[0].platform, "kind": used[0].device_kind,
        "count": len(used)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
