"""Real multi-host path: two jax.distributed-initialized CPU processes
(localhost coordinator) run ShardedEngine over a global 4-device mesh —
exercising the host-sharded device feed (`_put`'s
make_array_from_callback branch, dead code under single-process tests)
— and must match the single-process Engine exactly (SURVEY.md §4 test
plan item 4; VERDICT r1 next-round item 5)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_multihost_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_engine(tmp_path):
    out = str(tmp_path / "mh")
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env.update({"GX_COORD": f"localhost:{port}", "GX_OUT": out,
                "PYTHONUNBUFFERED": "1"})
    procs = []
    for pid in (0, 1):
        e = dict(env)
        e["GX_PID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=e, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        outs.append(stdout.decode(errors="replace"))
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"

    results = []
    for pid in (0, 1):
        with open(f"{out}.{pid}") as f:
            results.append(json.load(f))
    # Both hosts hold identical replicated results.
    assert results[0] == results[1]

    # And they match the single-process local Engine bit-for-bit (SW) /
    # to fp32 dispatch tolerance (PairHMM).
    sys.path.insert(0, REPO)
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine

    sys.path.insert(0, os.path.dirname(WORKER))
    import _multihost_worker as w

    pairs, batch = w.jobs()
    local = Engine(EngineConfig(backend="lax"))
    np.testing.assert_array_equal(
        np.asarray(results[0]["sw"], np.int32), local.sw_scores(pairs)
    )
    np.testing.assert_allclose(
        np.asarray(results[0]["ph"]), local.pairhmm([batch]), atol=1e-5
    )
    # The factored cuda-path pass (replicated unique-row tables + sharded
    # gather indices, ShardedEngine._put_replicated) must agree too.
    np.testing.assert_allclose(
        np.asarray(results[0]["ph_factored"]), local.pairhmm([batch]),
        atol=1e-4,
    )
