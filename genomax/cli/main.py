"""Command-line interface — drop-in analogue of the reference binaries.

Subcommands and their reference counterparts:
  sw        — antidiagonalSmithWaterman / smithWaterman.cu / hipvers:
              reads the pairs file, prints "Score: %d" per pair and
              "elapsed %f" (antidiagonalSmithWaterman.c:348-352); with
              --output appends scores to a file like hipvers.cpp:486-495.
  pairhmm   — pairHMMmatrix/antidiagsPairHMM/pairHMM.exe: <input> <output>
              with one "%f" log10-likelihood per line
              (pairHMMmatrix.c:115-116,258).
  generate  — generator.py, seeded and parameterized (the reference's
              committed copy ignores its CLI args, hiprun.sh:20).
  bench     — the hiprun.sh block-size sweep analogue: length buckets ×
              engine configs, GCUPS table.
  parity    — compiles the reference C sources (read-only, from
              /root/reference or --reference-dir) and diffs outputs.
  soak      — seeded randomized differential campaign vs the fp64
              oracles (the reference's by-hand differential testing,
              SURVEY.md §4, made automatic; testing/soak.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _maybe_profile(args):
    """jax.profiler trace context for --profile DIR (SURVEY.md §5: the
    reference's only tracing is a gettimeofday elapsed print)."""
    import contextlib

    if not getattr(args, "profile", None):
        return contextlib.nullcontext()
    import jax

    return jax.profiler.trace(args.profile)


def _build_engine(args):
    from genomax.config import EngineConfig, PairHMMConfig, SWConfig
    from genomax.engine.executor import Engine

    cfg_kw = {}
    if getattr(args, "max_device_len", None) is not None:
        cfg_kw["max_device_len"] = args.max_device_len
    cfg = EngineConfig(backend=args.backend, **cfg_kw)
    sw_cfg = SWConfig(
        match=args.match,
        mismatch=args.mismatch,
        gap_open=args.gap_open,
        gap_extend=args.gap_extend,
    )
    phmm_cfg = PairHMMConfig(
        gatk_emission=getattr(args, "gatk_emission", False),
    )
    if getattr(args, "chunk", None) and getattr(args, "devices", None):
        raise ValueError("--chunk streams through the local engine; "
                         "it cannot be combined with --devices")
    if getattr(args, "devices", None):
        # Multi-device path from the CLI: mesh over the first N devices
        # (make_mesh raises when there are fewer). Multi-host: start one
        # process per host with --coordinator/--num-processes/--process-id.
        from genomax.dist.engine import ShardedEngine
        from genomax.dist.mesh import initialize_distributed, make_mesh

        initialize_distributed(
            getattr(args, "coordinator", None),
            getattr(args, "num_processes", None),
            getattr(args, "process_id", None),
        )
        mesh = make_mesh(args.devices)
        return ShardedEngine(mesh, cfg, sw_cfg=sw_cfg, phmm_cfg=phmm_cfg)
    return Engine(cfg, sw_cfg=sw_cfg, phmm_cfg=phmm_cfg)


def _add_engine_args(p):
    p.add_argument("--backend", default="auto", choices=["auto", "cuda", "lax"],
                   help="cuda: the Hopper kernels (needs a GPU); lax: the "
                        "plain-JAX reference path; auto: cuda on a GPU")
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=-1)
    p.add_argument("--gap-open", type=int, default=-3)
    p.add_argument("--gap-extend", type=int, default=-1)
    p.add_argument("--gatk-emission", action="store_true",
                   help="use the true GATK mismatch emission Qr/3 instead "
                        "of the reference's plain Qr "
                        "(PairHMMConfig.gatk_emission; changes PairHMM "
                        "outputs vs the reference binaries)")
    p.add_argument("--stats", action="store_true", help="print JSON run stats to stderr")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a jax.profiler trace of the run into DIR "
                        "(view with tensorboard/xprof)")
    p.add_argument("--chunk", type=int, metavar="N",
                   help="stream the workload in chunks of N pairs "
                        "(sw) / N batches (pairhmm), host packing "
                        "overlapped with device execution "
                        "(engine/stream.py; local engine only)")
    p.add_argument("--devices", type=int, metavar="N",
                   help="score over an N-device mesh (ShardedEngine)")
    p.add_argument("--max-device-len", type=int, metavar="L",
                   help="pairs whose padded extent exceeds L are scored by "
                        "the native fp64 model instead of the device "
                        "(EngineConfig.max_device_len; default 1058)")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="multi-host: jax.distributed coordinator address")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)


def cmd_sw(args) -> int:
    from genomax.io.formats import parse_sw_file

    eng = _build_engine(args)
    pairs = parse_sw_file(args.input)
    t0 = time.time()
    with _maybe_profile(args):
        scores = (eng.sw_scores_stream(pairs, args.chunk)
                  if args.chunk else eng.sw_scores(pairs))
    elapsed = time.time() - t0
    lines = "".join("Score: %d\n" % s for s in scores)
    if args.output:
        with open(args.output, "a") as f:
            f.write(lines)
    else:
        sys.stdout.write(lines)
    print("elapsed %f" % elapsed)
    if args.stats:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
    return 0


def cmd_pairhmm(args) -> int:
    from genomax.io.formats import parse_pairhmm_file, write_pairhmm_output

    eng = _build_engine(args)
    batches = parse_pairhmm_file(args.input)
    if args.resume:
        return _pairhmm_resumable(args, eng, batches)
    t0 = time.time()
    with _maybe_profile(args):
        values = (eng.pairhmm_stream(batches, args.chunk)
                  if args.chunk else eng.pairhmm(batches))
    elapsed = time.time() - t0
    write_pairhmm_output(args.output, values)
    print("elapsed %f" % elapsed)
    if args.stats:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
    return 0


def _pairhmm_resumable(args, eng, batches) -> int:
    """Batch-indexed checkpoint/resume: per-batch output append + a
    manifest sidecar, so a killed run restarts at the next batch. The
    reference's batch loop appends output per batch and is naturally
    resumable but has no mechanism (pairHMM.cu:627-630; SURVEY.md §5)."""
    import os

    from genomax.io.formats import format_pairhmm_values

    manifest_path = args.output + ".progress.json"
    # Results already in the file must have been produced under the same
    # semantics, or the resumed output silently mixes two emission
    # models (SW scoring flags don't affect pairhmm values).
    fp = {"gatk_emission": bool(getattr(args, "gatk_emission", False))}
    done, lines = 0, 0
    if os.path.exists(manifest_path) and os.path.exists(args.output):
        with open(manifest_path) as f:
            m = json.load(f)
        # Legacy manifests predate some fingerprint keys; every missing
        # key was written under its historical default (False), so
        # normalize to that — NOT to the current flags, which would let
        # a pre-upgrade checkpoint silently resume under new semantics
        # (ADVICE r3). A manifest that recorded the r4-r5
        # scaled_recurrence step (deleted r5 — DESIGN §3b) restarts:
        # its outputs differ from the classic step within fp32.
        mcfg = m.get("config", {})
        stale_scaled = bool(mcfg.get("scaled_recurrence", False))
        mcfg = {k: bool(mcfg.get(k, False)) for k in fp}
        if m.get("input") != os.path.abspath(args.input):
            pass  # different workload: restart
        elif mcfg != fp or stale_scaled:
            print("resume manifest was written with different scoring "
                  "config; restarting from scratch", file=sys.stderr)
        else:
            done, lines = int(m["completed_batches"]), int(m["lines"])
    # Truncate any partial tail past the last checkpointed batch.
    if done:
        with open(args.output) as f:
            kept = [ln for _, ln in zip(range(lines), f)]
        if len(kept) < lines:
            # output shorter than the manifest claims (truncated or
            # corrupted): the checkpoint is unusable, restart cleanly
            print(f"output has {len(kept)} lines but manifest records "
                  f"{lines}; restarting from scratch", file=sys.stderr)
            done, lines, kept = 0, 0, []
        with open(args.output, "w") as f:
            f.writelines(kept)
        if done:
            print(f"resuming at batch {done}/{len(batches)}",
                  file=sys.stderr)
    else:
        open(args.output, "w").close()
    t0 = time.time()
    for i in range(done, len(batches)):
        vals = eng.pairhmm([batches[i]])
        with open(args.output, "a") as f:
            f.write(format_pairhmm_values(vals))
        lines += len(vals)
        with open(manifest_path, "w") as f:
            json.dump({"input": os.path.abspath(args.input),
                       "config": fp,
                       "completed_batches": i + 1, "lines": lines}, f)
    print("elapsed %f" % (time.time() - t0))
    if args.stats and eng.last_stats is not None:
        print(json.dumps(eng.last_stats.as_dict()), file=sys.stderr)
    return 0


def cmd_generate(args) -> int:
    from genomax.io.generator import write_sw_file

    write_sw_file(
        args.output,
        num_alignments=args.num,
        min_len=args.min_len,
        max_len=args.max_len,
        seed=args.seed,
    )
    print(f"wrote {2 * args.num} sequences ({args.num} alignments) to {args.output}")
    return 0


def cmd_bench(args) -> int:
    if args.kernel == "pairhmm":
        from genomax.bench.sweep import run_pairhmm_sweep

        pts = []
        for spec in args.pairhmm_points.split(";"):
            nr, nh, rl, hl = (int(x) for x in spec.split(","))
            pts.append((nr, nh, rl, hl))
        run_pairhmm_sweep(pts, backend=args.backend, json_out=args.json)
        return 0
    from genomax.bench.sweep import run_sweep

    run_sweep(
        lengths=[int(x) for x in args.lengths.split(",")],
        num_alignments=args.num,
        backend=args.backend,
        json_out=args.json,
    )
    return 0


def cmd_bench_dist(args) -> int:
    counts = [int(x) for x in args.devices.split(",")]
    from genomax.bench.scaling import run_scaling

    run_scaling(
        device_counts=counts,
        num_alignments=args.num,
        length=args.length,
        backend=args.backend,
        json_out=args.json,
    )
    return 0


def cmd_parity(args) -> int:
    from genomax.testing.parity import run_parity

    return run_parity(reference_dir=args.reference_dir, backend=args.backend)


def cmd_soak(args) -> int:
    from genomax.testing import soak

    return soak.main(args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="genomax", description="pairwise alignment scoring engine (JAX)"
    )
    import genomax as _pkg

    ap.add_argument("--version", action="version", version=f"genomax {_pkg.__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sw", help="Smith-Waterman affine-gap scores for a pairs file")
    p.add_argument("input")
    p.add_argument("--output", help="append 'Score: N' lines to this file")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_sw)

    p = sub.add_parser("pairhmm", help="PairHMM forward log10 likelihoods")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--resume", action="store_true",
                   help="batch-granular checkpoint/resume via a "
                        "<output>.progress.json manifest")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_pairhmm)

    p = sub.add_parser("generate", help="random ATGC SW input file")
    p.add_argument("output")
    p.add_argument("--num", type=int, default=500)
    p.add_argument("--min-len", type=int, default=450)
    p.add_argument("--max-len", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("bench", help="length x config GCUPS sweep")
    p.add_argument("--kernel", default="sw", choices=["sw", "pairhmm"])
    p.add_argument("--pairhmm-points",
                   default="1024,8,151,300;4096,8,151,300;1024,8,250,400",
                   help="semicolon-separated n_reads,n_haps,read_len,hap_len")
    p.add_argument("--lengths", default="64,128,256,512,1024")
    p.add_argument("--num", type=int, default=25000, help="alignments per point")
    p.add_argument("--backend", default="auto")
    p.add_argument("--json", help="write results as JSON to this path")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("bench-dist", help="pairs/s scaling over a device mesh")
    p.add_argument("--devices", default="1,2,4",
                   help="device counts to sweep (the platform must have "
                        "the largest)")
    p.add_argument("--num", type=int, default=2048, help="alignments")
    p.add_argument("--length", type=int, default=256)
    p.add_argument("--backend", default="auto")
    p.add_argument("--json", help="write results as JSON to this path")
    p.set_defaults(fn=cmd_bench_dist)

    p = sub.add_parser("parity", help="diff against the reference C binaries")
    p.add_argument("--reference-dir", default="/root/reference")
    p.add_argument("--backend", default="auto")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser(
        "soak", help="randomized differential soak vs the fp64 oracles "
                     "(the committed form of PERF.md's hardware campaigns)")
    p.add_argument("--rounds", type=int, default=24)
    p.add_argument("--seed", type=int, default=20260817)
    p.add_argument("--deep", action="store_true",
                   help="deep path: ShardedEngine on a mesh")
    p.add_argument("--devices", type=int, default=1,
                   help="mesh size for --deep's sharded rounds")
    p.add_argument("--backend", default="auto")
    p.set_defaults(fn=cmd_soak)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"genomax: error: no such file: {e.filename}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"genomax: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
