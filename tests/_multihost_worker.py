"""Worker process for the multi-host CI test (tests/test_multihost.py).

Each of the 2 processes contributes 2 virtual CPU devices to a global
4-device mesh, runs ShardedEngine on an identical job list, and writes
its (replicated) results to GX_OUT.<pid>. This executes the REAL
multi-host feed: jax.process_count() > 1 makes ShardedEngine._put take
the make_array_from_callback branch, so each process materializes only
its addressable tile shards (SURVEY.md §2.4 / §4 test plan item 4).
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def jobs():
    from genomax.io.formats import SWPair
    from genomax.io.generator import generate_pairhmm_batch

    rng = np.random.default_rng(5)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = []
    for _ in range(40):
        a = rng.choice(abc, int(rng.integers(5, 40))).tobytes()
        b = rng.choice(abc, int(rng.integers(5, 40))).tobytes()
        if len(a) > len(b):
            a, b = b, a
        pairs.append(SWPair(sx=a, sy=b))
    batch = generate_pairhmm_batch(3, 2, read_len=13, hap_len=17, seed=6)
    return pairs, batch


def main():
    pid = int(os.environ["GX_PID"])
    from genomax.config import EngineConfig
    from genomax.dist.engine import ShardedEngine
    from genomax.dist.mesh import initialize_distributed, make_mesh

    initialize_distributed(
        os.environ["GX_COORD"], num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    mesh = make_mesh(devices=jax.devices())
    assert mesh.devices.size == 4

    pairs, batch = jobs()
    eng = ShardedEngine(mesh, EngineConfig(backend="lax"))
    sw = eng.sw_scores(pairs)
    ph = eng.pairhmm([batch])
    # Factored pass through the cuda dispatch, with the kernel replaced by
    # its lax twin (tests/conftest.py): multi-process is the only place
    # _put_replicated's make_array_from_callback branch runs (the
    # unique-row tables must be replicated to every host's shards).
    import conftest
    from genomax.kernels import cuda

    jax.default_backend = lambda: "gpu"
    cuda.register = lambda: None
    cuda.pairhmm_tiles = conftest._lax_pairhmm_tiles
    eng_f = ShardedEngine(
        mesh, EngineConfig(backend="cuda", factored_transfer=True))
    ph_f = eng_f.pairhmm([batch])
    with open(os.environ["GX_OUT"] + f".{pid}", "w") as f:
        json.dump(
            {"sw": np.asarray(sw).tolist(),
             "ph": np.asarray(ph, np.float64).tolist(),
             "ph_factored": np.asarray(ph_f, np.float64).tolist()},
            f,
        )


if __name__ == "__main__":
    main()
