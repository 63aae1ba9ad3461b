"""Randomized differential soaks — the committed form of the hardware
soak campaigns recorded in PERF.md §Parity.

The reference's correctness strategy is differential testing between
its implementations run by hand (SURVEY.md §4; pairHMM/run.sh:2-8,
README.md:2 "coherent with my C version"). genomax automates it as a
seeded randomized campaign against the fp64 oracles:

- ``run_soak``      — the compiled engine (every launch shape, oversized
  offloads, fp64 fallbacks, both emission modes, 'N' alphabets, tandem
  and '\\n'-quirk adversaries) vs ``kernels.oracle``.
- ``run_deep_soak`` — ShardedEngine on a device mesh (the kernels inside
  shard_map) vs ``kernels.oracle``.

CLI: ``genomax soak [--deep] [--rounds N] [--seed S]``. Any mismatch
aborts loudly with the failing workload's parameters.
"""

from __future__ import annotations

import sys
import time

import numpy as np

_ABC4 = np.frombuffer(b"ATGC", np.uint8)
_ABCN = np.frombuffer(b"ATGCN", np.uint8)


def _seq(rng, n, alphabet=_ABC4) -> bytes:
    return rng.choice(alphabet, max(int(n), 0)).tobytes()


def run_soak(rounds: int = 60, seed: int = 20260817, backend: str = "auto",
             max_len: int = 700, log=print) -> int:
    """Engine-vs-oracle randomized soak. Returns 0 on PASS, 1 on the
    first mismatch (after logging the failing parameters)."""
    from genomax.config import EngineConfig, PairHMMConfig, SWConfig
    from genomax.engine.executor import Engine
    from genomax.io.formats import PairHMMBatch, PairHMMRead, SWPair
    from genomax.kernels import oracle

    rng = np.random.default_rng(seed)
    t_start = time.time()
    for rd_i in range(rounds):
        if rd_i % 3 in (0, 1):  # SW round
            cfg = SWConfig() if rd_i % 2 == 0 else SWConfig(
                match=int(rng.integers(1, 5)),
                mismatch=-int(rng.integers(1, 5)),
                gap_open=-int(rng.integers(0, 6)),
                gap_extend=-int(rng.integers(1, 4)))
            lo, hi = sorted(rng.integers(1, max_len, size=2) + [0, 2])
            if rd_i % 6 == 1:
                # pin a steady share of rounds to the short regime (the
                # narrow launch shapes) — a uniform [1, max_len) draw
                # lands there only ~3% of the time
                lo, hi = sorted(rng.integers(1, 110, size=2) + [0, 2])
            alphabet = _ABCN if rd_i % 4 == 0 else _ABC4
            pairs = []
            for _ in range(int(rng.integers(8, 40))):
                a = _seq(rng, rng.integers(lo, hi + 1), alphabet)
                b = _seq(rng, rng.integers(lo, hi + 1), alphabet)
                if rng.random() < 0.5:  # the '\n'-in-sequence quirk
                    a += b"\n"
                    b += b"\n"
                if len(a) > len(b):
                    a, b = b, a
                pairs.append(SWPair(sx=a, sy=b))
            if rng.random() < 0.3:  # tandem-repeat adversary
                x = _seq(rng, min(hi, 400))
                pairs.append(SWPair(sx=x, sy=x + _seq(rng, rng.integers(1, 300)) + x))
            if rng.random() < 0.2:  # oversized -> offload path
                pairs.append(SWPair(sx=_seq(rng, 1200), sy=_seq(rng, 1400)))
            e = Engine(EngineConfig(backend=backend), sw_cfg=cfg)
            got = e.sw_scores(pairs)
            want = oracle.sw_scores_pairs(pairs, cfg)
            bad = np.nonzero(got != want)[0]
            stat = (f"SW n={len(pairs)} len[{lo},{hi}] cfg=({cfg.match},"
                    f"{cfg.mismatch},{cfg.gap_open},{cfg.gap_extend})")
            if len(bad):
                log(f"round {rd_i}: {stat} MISMATCH at {bad[:5]}: "
                    f"got {got[bad[:5]]} want {want[bad[:5]]}")
                return 1
        else:  # PairHMM round
            gatk = rng.random() < 0.5
            pcfg = PairHMMConfig(gatk_emission=gatk)
            nr, nh = int(rng.integers(1, 5)), int(rng.integers(1, 4))
            rl_hi = int(rng.integers(10, min(260, max_len)))
            hl_hi = int(rng.integers(10, min(400, max_len)))
            reads, haps = [], []
            for _ in range(nr):
                L = int(rng.integers(1, rl_hi + 1))
                qs = bytes((33 + rng.integers(10, 45, size=L)).astype(np.uint8))
                alphabet = _ABCN if rng.random() < 0.3 else _ABC4
                reads.append(PairHMMRead(bases=_seq(rng, L, alphabet),
                                         base_q=qs, ins_q=qs[::-1],
                                         del_q=qs, gcp_q=qs))
            for _ in range(nh):
                alphabet = _ABCN if rng.random() < 0.3 else _ABC4
                haps.append(_seq(rng, rng.integers(1, hl_hi + 1), alphabet))
            batch = PairHMMBatch(reads=reads, haplotypes=haps)
            e = Engine(EngineConfig(backend=backend), phmm_cfg=pcfg)
            got = np.asarray(e.pairhmm([batch]), np.float64)
            want = oracle.pairhmm_batch_log10(batch, pcfg)
            finite = np.isfinite(want)
            worst = np.abs(got - want)[finite].max() if finite.any() else 0.0
            nan_ok = (bool(np.all(~np.isfinite(got[~finite])))
                      if (~finite).any() else True)
            stat = (f"PHMM {nr}x{nh} rl<={rl_hi} hl<={hl_hi} gatk={gatk} "
                    f"err={worst:.1e} fb={e.last_stats.fallback_jobs}")
            if worst > 2e-4 or not nan_ok:
                log(f"round {rd_i}: {stat} FAIL")
                return 1
        log(f"round {rd_i}: OK  {stat}  [{time.time() - t_start:.0f}s]")
    log("SOAK PASS")
    return 0


def run_deep_soak(rounds: int = 16, seed: int = 3_2026,
                  backend: str = "auto", devices: int = 1,
                  log=print) -> int:
    """Deep-path soak: ShardedEngine on a `devices`-device mesh, SW and
    PairHMM each round. Returns 0 on PASS, 1 on the first mismatch."""
    from genomax.config import EngineConfig
    from genomax.dist.engine import ShardedEngine
    from genomax.dist.mesh import make_mesh
    from genomax.io.formats import PairHMMBatch, PairHMMRead, SWPair
    from genomax.kernels import oracle

    rng = np.random.default_rng(seed)
    mesh = make_mesh(devices)
    log(f"mesh devices: {mesh.devices}")
    t_start = time.time()
    for rd_i in range(rounds):
        lo, hi = sorted(rng.integers(1, 500, size=2) + [0, 2])
        pairs = []
        for _ in range(int(rng.integers(8, 30))):
            a = _seq(rng, rng.integers(lo, hi + 1))
            b = _seq(rng, rng.integers(lo, hi + 1))
            if len(a) > len(b):
                a, b = b, a
            pairs.append(SWPair(sx=a, sy=b))
        dist = ShardedEngine(mesh, EngineConfig(backend=backend))
        got = dist.sw_scores(pairs)
        want = oracle.sw_scores_pairs(pairs)
        if not np.array_equal(got, want):
            log(f"round {rd_i}: SHARDED SW MISMATCH {got} vs {want}")
            return 1
        nr, nh = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        reads = []
        for _ in range(nr):
            L = int(rng.integers(5, 200))
            qs = bytes((33 + rng.integers(10, 45, size=L)).astype(np.uint8))
            reads.append(PairHMMRead(bases=_seq(rng, L, _ABCN), base_q=qs,
                                     ins_q=qs[::-1], del_q=qs, gcp_q=qs))
        haps = [_seq(rng, rng.integers(5, 300), _ABCN) for _ in range(nh)]
        batch = PairHMMBatch(reads=reads, haplotypes=haps)
        gp = np.asarray(dist.pairhmm([batch]), np.float64)
        wp = oracle.pairhmm_batch_log10(batch)
        finite = np.isfinite(wp)
        worst = np.abs(gp - wp)[finite].max() if finite.any() else 0.0
        if worst > 2e-4:
            log(f"round {rd_i}: SHARDED PHMM err={worst:.1e} FAIL")
            return 1
        stat = (f"SHARDED-{devices}dev sw n={len(pairs)} phmm {nr}x{nh} "
                f"err={worst:.1e} gcups={dist.last_stats.gcups:.1f}")
        log(f"round {rd_i}: OK  {stat}  [{time.time() - t_start:.0f}s]")
    log("DEEP SOAK PASS")
    return 0


def main(args) -> int:
    if args.deep:
        return run_deep_soak(rounds=args.rounds, seed=args.seed,
                             backend=args.backend,
                             devices=args.devices or 1)
    return run_soak(rounds=args.rounds, seed=args.seed, backend=args.backend)


if __name__ == "__main__":  # pragma: no cover - thin hand-run entry
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--seed", type=int, default=20260817)
    ap.add_argument("--deep", action="store_true")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--backend", default="auto")
    sys.exit(main(ap.parse_args()))
