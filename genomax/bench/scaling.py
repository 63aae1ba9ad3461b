"""Multi-device scaling benchmark: pairs/s and parallel efficiency at
1..N devices (BASELINE.json: "pairs/s scaling efficiency at 1 chip,
1 host, and N>=2 hosts"), over the platform's own devices
(``initialize_distributed`` extends the mesh across hosts).
"""

from __future__ import annotations

import json
import time

import numpy as np


def bench_scaling_point(n_devices: int, pairs, backend: str, trials: int = 3,
                        devices=None):
    from genomax.config import EngineConfig
    from genomax.dist.engine import ShardedEngine
    from genomax.dist.mesh import make_mesh

    mesh = make_mesh(n_devices, devices=devices)
    eng = ShardedEngine(mesh, EngineConfig(backend=backend))
    eng.sw_scores(pairs)  # compile + warm
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        eng.sw_scores(pairs)
        best = min(best, time.perf_counter() - t0)
    return {
        "devices": n_devices,
        "elapsed_ms": round(best * 1e3, 2),
        "pairs_per_s": round(len(pairs) / best, 1),
    }


def run_scaling(device_counts, num_alignments: int, length: int,
                backend: str = "auto", json_out=None):
    from genomax.io.formats import SWPair
    from genomax.io.generator import random_dna

    rng = np.random.default_rng(0)
    pairs = [
        SWPair(sx=random_dna(rng, length) + b"\n", sy=random_dna(rng, length) + b"\n")
        for _ in range(num_alignments)
    ]
    import jax

    devices = jax.devices()
    if len(devices) < max(device_counts):
        raise SystemExit(
            f"need {max(device_counts)} devices, have {len(devices)}")
    rows = []
    base = None
    print(f"SW scaling: {num_alignments} x {length}bp, backend={backend}, "
          f"platform={devices[0].platform} ({devices[0].device_kind})")
    print(f"{'devices':>8} {'ms':>10} {'pairs/s':>12} {'speedup':>8} {'efficiency':>10}")
    for n in device_counts:
        try:
            r = bench_scaling_point(n, pairs, backend, devices=devices[:n])
        except ValueError as e:
            print(f"{n:>8}   -- {e}")
            continue
        if base is None:
            base, base_n = r["pairs_per_s"], n
        r["speedup"] = round(r["pairs_per_s"] / base, 2)
        # normalize to the first SUCCESSFUL point, so a skipped first
        # count cannot make speedup and efficiency disagree
        r["efficiency"] = round(r["speedup"] / (n / base_n), 3)
        rows.append(r)
        print(f"{n:>8} {r['elapsed_ms']:>10.1f} {r['pairs_per_s']:>12.1f} "
              f"{r['speedup']:>8.2f} {r['efficiency']:>10.3f}")
    if json_out:
        with open(json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows
