"""CLI-level tests (lax backend on CPU): output formats, quirks,
checkpoint/resume manifest."""

import json
import os

import numpy as np
import pytest

from genomax.cli.main import main
from genomax.io.generator import generate_pairhmm_batch


def _write_pairhmm_input(path, batches):
    with open(path, "w") as f:
        for b in batches:
            f.write(f"{len(b.reads)} {len(b.haplotypes)}\n")
            for r in b.reads:
                f.write(" ".join(x.decode() for x in
                                 (r.bases, r.base_q, r.ins_q, r.del_q, r.gcp_q)) + "\n")
            for h in b.haplotypes:
                f.write(h.decode() + "\n")


@pytest.fixture()
def phmm_file(tmp_path):
    batches = [
        generate_pairhmm_batch(2, 2, read_len=11, hap_len=15, seed=i)
        for i in range(4)
    ]
    p = tmp_path / "in.txt"
    _write_pairhmm_input(p, batches)
    return str(p)


def test_cli_sw_scores_and_elapsed(tmp_path, capsys, golden_dir):
    rc = main(["sw", os.path.join(golden_dir, "sw_small.in"), "--backend", "lax"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("Score: ")]
    want = [f"Score: {l.split()[1]}" for l in
            open(os.path.join(golden_dir, "sw_small.golden.out"))]
    assert lines == want
    assert "elapsed " in out


def test_cli_missing_file(capsys):
    rc = main(["sw", "/definitely/not/here.in", "--backend", "lax"])
    assert rc == 2
    assert "no such file" in capsys.readouterr().err


def test_cli_pairhmm_resume_matches_full(tmp_path, phmm_file):
    full = str(tmp_path / "full.out")
    rc = main(["pairhmm", phmm_file, full, "--backend", "lax"])
    assert rc == 0

    # resumable run from scratch
    res = str(tmp_path / "res.out")
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    assert open(res).read() == open(full).read()
    m = json.load(open(res + ".progress.json"))
    assert m["completed_batches"] == 4

    # simulate a crash after batch 2 (manifest says 2, file has a torn
    # extra line): resume must truncate the tail and reproduce the rest
    lines = open(res).readlines()
    per_batch = len(lines) // 4
    torn = lines[: 2 * per_batch] + ["-999.0\n"]
    open(res, "w").writelines(torn)
    json.dump({"input": os.path.abspath(phmm_file),
               "completed_batches": 2, "lines": 2 * per_batch},
              open(res + ".progress.json", "w"))
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    assert open(res).read() == open(full).read()


def test_cli_pairhmm_resume_ignores_other_input_manifest(tmp_path, phmm_file):
    res = str(tmp_path / "res.out")
    open(res, "w").write("junk\n")
    json.dump({"input": "/some/other/file", "completed_batches": 2, "lines": 1},
              open(res + ".progress.json", "w"))
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    # manifest for a different input must be ignored: fresh full output
    vals = np.loadtxt(res)
    assert len(vals) == 16


def test_cli_pairhmm_resume_truncated_output_restarts(tmp_path, phmm_file):
    """Output shorter than the manifest records (truncated/corrupted):
    resume must restart cleanly, not die in StopIteration (round-3
    self-review finding)."""
    res = str(tmp_path / "res.out")
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    full = open(res).read()
    m = json.load(open(res + ".progress.json"))
    # chop the output to fewer lines than the manifest claims
    open(res, "w").writelines(full.splitlines(True)[:2])
    assert m["lines"] > 2
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    assert open(res).read() == full


def test_cli_pairhmm_resume_config_mismatch_restarts(tmp_path, phmm_file,
                                                     capsys):
    """Resuming under a different emission model must restart from
    scratch, not mix plain-Qr and Qr/3 values in one output file."""
    res = str(tmp_path / "res.out")
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    plain = open(res).read()
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax",
               "--gatk-emission"])
    assert rc == 0
    assert "different scoring config" in capsys.readouterr().err
    gatk = open(res).read()
    assert len(gatk.splitlines()) == len(plain.splitlines())
    assert gatk != plain  # all-Qr/3 output, no mixed prefix
    full_gatk = str(tmp_path / "full_gatk.out")
    rc = main(["pairhmm", phmm_file, full_gatk, "--backend", "lax",
               "--gatk-emission"])
    assert rc == 0
    assert gatk == open(full_gatk).read()


def test_cli_generate_roundtrip(tmp_path):
    """generate -> sw pipeline: seeded, parameterized (the reference's
    committed generator.py ignores its CLI args, hiprun.sh:20)."""
    from genomax.io.formats import parse_sw_file

    p = str(tmp_path / "gen.txt")
    rc = main(["generate", p, "--num", "10", "--min-len", "30",
               "--max-len", "40", "--seed", "7"])
    assert rc == 0
    pairs = parse_sw_file(p)
    assert len(pairs) == 10
    # the '\n' quirk: generated sequences carry the trailing newline
    assert all(pr.sx.endswith(b"\n") and pr.sy.endswith(b"\n") for pr in pairs)
    assert all(31 <= len(pr.sx) <= 41 for pr in pairs)
    # determinism
    p2 = str(tmp_path / "gen2.txt")
    main(["generate", p2, "--num", "10", "--min-len", "30",
          "--max-len", "40", "--seed", "7"])
    assert open(p).read() == open(p2).read()


def test_bench_driver_contract_tiny(capsys):
    """bench.py end-to-end in tiny mode: the driver contract is exactly
    one JSON line on stdout with metric/value/unit/vs_baseline."""
    import importlib
    import os

    os.environ["GENOMAX_BENCH_TINY"] = "1"
    try:
        import bench

        importlib.reload(bench)
        bench.main()
    finally:
        del os.environ["GENOMAX_BENCH_TINY"]
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    rec = json.loads(out[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    # tiny mode runs on the CPU: the record names it, so it cannot pass
    # for a GPU number
    assert rec["device"]["platform"] == "cpu"
    assert rec["unit"] == "GCUPS" and rec["value"] >= 0


def test_sw_devices_flag_sharded(tmp_path, capsys):
    """--devices N routes through ShardedEngine over an N-device mesh
    (the suite's virtual CPU devices here)."""
    from genomax.kernels import oracle
    from genomax.io.formats import parse_sw_file

    p = str(tmp_path / "in.txt")
    main(["generate", p, "--num", "12", "--min-len", "20",
          "--max-len", "30", "--seed", "3"])
    capsys.readouterr()
    rc = main(["sw", p, "--backend", "lax", "--devices", "2", "--stats"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    scores = [int(line.split()[1]) for line in out if line.startswith("Score:")]
    want = oracle.sw_scores_pairs(parse_sw_file(p))
    np.testing.assert_array_equal(np.array(scores), want)


def test_cli_profile_flag_writes_trace(tmp_path, capsys, golden_dir):
    """--profile DIR captures a jax.profiler trace of the run (SURVEY §5
    tracing plan); the trace dir must exist and be non-empty after."""
    d = str(tmp_path / "trace")
    rc = main(["sw", os.path.join(golden_dir, "sw_small.in"),
               "--backend", "lax", "--profile", d])
    capsys.readouterr()
    assert rc == 0
    assert os.path.isdir(d)
    found = [f for _, _, fs in os.walk(d) for f in fs]
    assert found, "profiler trace produced no files"


def test_cli_soak_smoke():
    """`genomax soak` (the committed form of PERF.md's hardware soak
    campaigns) runs a short seeded engine-vs-oracle campaign."""
    rc = main(["soak", "--rounds", "3", "--backend", "lax", "--seed", "7"])
    assert rc == 0


def test_soak_deep_smoke():
    """Deep soak covers ShardedEngine on a mesh, shrunk to suite size."""
    from genomax.testing.soak import run_deep_soak

    rc = run_deep_soak(rounds=2, seed=11, backend="lax", devices=2,
                       log=lambda *_: None)
    assert rc == 0


def test_cli_pairhmm_resume_legacy_manifest_restarts(tmp_path, phmm_file,
                                                     capsys):
    """A pre-config-fingerprint manifest (no 'config' key) was written
    under the historical default (reference emission). Resuming under
    --gatk-emission must restart, not silently adopt the new flags
    (ADVICE r3)."""
    import json as _json

    res = str(tmp_path / "res.out")
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    plain = open(res).read()
    # Strip the config key, simulating a legacy manifest.
    man = res + ".progress.json"
    m = _json.load(open(man))
    del m["config"]
    _json.dump(m, open(man, "w"))
    # Same flags as the historical default: resume is allowed (no-op run).
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    assert open(res).read() == plain
    # Different emission: must restart from scratch.
    _json.dump(m, open(man, "w"))
    capsys.readouterr()
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax",
               "--gatk-emission"])
    assert rc == 0
    assert "different scoring config" in capsys.readouterr().err
    assert open(res).read() != plain


def test_module_entry_propagates_exit_code():
    """`python -m genomax` must propagate the CLI's return code — the
    parity contract (`python -m genomax parity`) is meaningless if rc is
    swallowed (__main__.py once called main() without sys.exit)."""
    import subprocess
    import sys as _sys

    r = subprocess.run(
        [_sys.executable, "-m", "genomax", "sw", "/definitely/missing.in"],
        capture_output=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        timeout=120,
    )
    assert r.returncode == 2, (r.returncode, r.stderr[-200:])


def test_bench_refuses_without_gpu(capsys):
    """Outside its tiny rehearsal mode bench.py measures only a GPU: on
    the CPU it refuses with exit 2 and prints no JSON line."""
    import importlib

    import bench

    importlib.reload(bench)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs an NVIDIA GPU" in captured.err


def test_cli_backend_cuda_without_gpu_fails(tmp_path, golden_dir):
    """--backend cuda on a host without a GPU is an error, never a
    silent fallback to another backend."""
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        main(["sw", os.path.join(golden_dir, "sw_small.in"),
              "--backend", "cuda"])


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where JAX finds
    no GPU, and also where it stands alone without the package."""
    import shutil
    import subprocess
    import sys as _sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([_sys.executable, "chip_smoke.py"], cwd=repo,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr
    shutil.copy(os.path.join(repo, "chip_smoke.py"), tmp_path)
    r = subprocess.run([_sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


def test_cli_pairhmm_resume_stale_scaled_manifest_restarts(tmp_path,
                                                           phmm_file,
                                                           capsys):
    """A checkpoint manifest written by the r4-r5 scaled-recurrence
    step (flag deleted r5, DESIGN §3b) must NOT silently resume: its
    outputs differ from the classic step inside the fp32 envelope."""
    import json as _json

    res = str(tmp_path / "res.out")
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    manifest = res + ".progress.json"
    with open(manifest) as f:
        m = _json.load(f)
    m["config"]["scaled_recurrence"] = True  # as the r4-r5 CLI wrote it
    with open(manifest, "w") as f:
        _json.dump(m, f)
    capsys.readouterr()
    rc = main(["pairhmm", phmm_file, res, "--resume", "--backend", "lax"])
    assert rc == 0
    assert "different scoring config" in capsys.readouterr().err
