"""Benchmark sweep — the analogue of the reference's hiprun.sh block-size
sweep (smithWaterman/hiprun.sh:18-39: lengths {64..1024}, 25,000
alignments per point; results charted in project_presentation.pptx
slides 10-14, tabulated in BASELINE.md). Each point runs the engine's own
path (Engine.sw_scores / Engine.pairhmm, the backend EngineConfig picks)
end to end: warm-up once, then the median of ``trials`` timed runs with
the results fetched to the host."""

from __future__ import annotations

import json
import statistics
import time

import numpy as np


def _median_time(fn, trials: int) -> float:
    fn()  # compile + warm
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def bench_sw_point(length: int, num_alignments: int, backend: str,
                   trials: int = 3, seed: int = 0):
    """One sweep point: fixed-length random pairs (with the reference's
    trailing-'\\n' byte) through Engine.sw_scores."""
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine
    from genomax.io.formats import SWPair
    from genomax.io.generator import random_dna

    rng = np.random.default_rng(seed)
    pairs = [
        SWPair(sx=random_dna(rng, length) + b"\n",
               sy=random_dna(rng, length) + b"\n")
        for _ in range(num_alignments)
    ]
    eng = Engine(EngineConfig(backend=backend))
    per = _median_time(lambda: eng.sw_scores(pairs), trials)
    cells = num_alignments * (length + 1) ** 2  # incl. '\n' lane, like the C
    return {
        "length": length,
        "backend": eng.backend,
        "elapsed_ms": round(per * 1e3, 3),
        "gcups": round(cells / per / 1e9, 3),
    }


def run_sweep(lengths, num_alignments, backend, json_out=None):
    rows = []
    print(f"SW sweep: {num_alignments} alignments per point, backend={backend}")
    print(f"{'LEN':>6} {'ms':>10} {'GCUPS':>8}")
    for L in lengths:
        r = bench_sw_point(L, num_alignments, backend)
        rows.append(r)
        print(f"{L:>6} {r['elapsed_ms']:>10.1f} {r['gcups']:>8.2f}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def bench_pairhmm_point(n_reads: int, n_haps: int, read_len: int,
                        hap_len: int, backend: str, trials: int = 3,
                        seed: int = 0):
    """One PairHMM sweep point (the reference tuned PairHMM the same way
    but withheld the numbers, report_gkl_hpps.pdf §5): HaplotypeCaller-
    shaped reads (generate_pairhmm_batch from_haps) through
    Engine.pairhmm."""
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine
    from genomax.io.generator import generate_pairhmm_batch

    batch = generate_pairhmm_batch(n_reads, n_haps, read_len=read_len,
                                   hap_len=hap_len, seed=seed, from_haps=True)
    cells = sum(len(r.bases) * len(h)
                for r in batch.reads for h in batch.haplotypes)
    eng = Engine(EngineConfig(backend=backend))
    per = _median_time(lambda: eng.pairhmm([batch]), trials)
    return {
        "pairs": n_reads * n_haps,
        "read_len": read_len,
        "hap_len": hap_len,
        "backend": eng.backend,
        "elapsed_ms": round(per * 1e3, 3),
        "gcups": round(cells / per / 1e9, 3),
    }


def run_pairhmm_sweep(points, backend, json_out=None):
    """points: list of (n_reads, n_haps, read_len, hap_len)."""
    rows = []
    print(f"PairHMM sweep, backend={backend}")
    print(f"{'pairs':>8} {'read':>6} {'hap':>6} {'ms':>10} {'GCUPS':>8}")
    for nr, nh, rl, hl in points:
        r = bench_pairhmm_point(nr, nh, rl, hl, backend)
        rows.append(r)
        print(f"{r['pairs']:>8} {rl:>6} {hl:>6} {r['elapsed_ms']:>10.1f} "
              f"{r['gcups']:>8.2f}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows
