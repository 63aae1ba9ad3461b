"""Driver benchmark: prints ONE JSON line with the headline metric.

Headline = Smith-Waterman GCUPS end to end through ``Engine.sw_scores``
(pack, transfer, kernels, unpack) on the reference's own benchmark point:
25,000 alignments of 512bp random DNA plus the reference generator's
trailing '\\n' byte (project_presentation.pptx slides 9-11; BASELINE.md:
best reference-GPU time 110.10 ms = ~59.5 GCUPS, the vs_baseline
denominator). Warm: one compiling call, then the median of three runs,
results fetched to the host. The record names the device it ran on
(platform, device_kind, count) and the card's name and power limit.

Without a GPU it refuses (exit 2, no JSON line), except in the tiny CPU
rehearsal of the contract (GENOMAX_BENCH_TINY=1, lax backend). Secondary
points (PairHMM on 10s.in and on 65,536 read x haplotype pairs) go to
stderr after the JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REF_GPU_GCUPS_512 = 59.5  # BASELINE.md: 25k x 512^2 cells / 110.10 ms
RUNS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def warm_median(fn) -> float:
    fn()  # compile
    ts = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    tiny = os.environ.get("GENOMAX_BENCH_TINY", "").lower() not in (
        "", "0", "false", "no")
    import jax

    import genomax
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine
    from genomax.io.formats import SWPair, parse_pairhmm_file
    from genomax.io.generator import generate_pairhmm_batch, random_dna

    devices = jax.devices()
    if not tiny and devices[0].platform != "gpu":
        log(f"bench.py: needs an NVIDIA GPU, JAX found "
            f"{devices[0].platform!r}; refusing to emit a number "
            "(GENOMAX_BENCH_TINY=1 rehearses the contract on the CPU)")
        sys.exit(2)
    genomax.setup_compilation_cache()
    card = None
    if not tiny:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    eng = Engine(EngineConfig(backend="lax" if tiny else "auto"))
    log(f"backend {eng.backend} on {devices[0].device_kind} "
        f"({len(devices)} devices); card: {card}")

    rng = np.random.default_rng(0)
    n, L = (128, 32) if tiny else (25000, 512)
    pairs = [SWPair(sx=random_dna(rng, L) + b"\n",
                    sy=random_dna(rng, L) + b"\n") for _ in range(n)]
    t = warm_median(lambda: eng.sw_scores(pairs))
    gcups = eng.last_stats.dp_cells / t / 1e9
    st = eng.last_stats
    log(f"SW {n} x {L}bp: {t * 1e3:.3f} ms end to end (pack "
        f"{st.pack_s * 1e3:.3f} ms, dispatch+fetch {st.exec_s * 1e3:.3f} ms)"
        f" = {gcups:.3f} GCUPS; {card}")
    print(json.dumps({
        "metric": "SW affine-gap GCUPS end to end, 25k x 512bp alignments "
                  "(ref headline)",
        "value": round(gcups, 3),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / REF_GPU_GCUPS_512, 3),
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices), "card": card},
    }), flush=True)

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    batches = parse_pairhmm_file(os.path.join(golden, "10s.in"))
    t = warm_median(lambda: eng.pairhmm(batches))
    got = eng.pairhmm(batches)
    err = float(np.abs(np.asarray(got, np.float64) - np.loadtxt(
        os.path.join(golden, "10s.golden.out"))).max())
    log(f"PairHMM 10s.in: {t * 1e3:.3f} ms end to end, max|err| {err:.2e}, "
        f"fp64 fallbacks {eng.last_stats.fallback_jobs}; {card}")
    if tiny:
        return
    big = generate_pairhmm_batch(8192, 8, read_len=151, hap_len=300, seed=0,
                                 from_haps=True)
    t = warm_median(lambda: eng.pairhmm([big]))
    log(f"PairHMM 65536 x 151 x 300: {t * 1e3:.3f} ms end to end = "
        f"{eng.last_stats.dp_cells / t / 1e9:.3f} GCUPS; {card}")


if __name__ == "__main__":
    main()
