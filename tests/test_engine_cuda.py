"""The engine's cuda path on the CPU: everything around the kernels —
ragged buckets and launch shapes, the unpack order, offload of long pairs
to the native model, the fp64 fallback and the transfer ladder — with the
kernel entry points replaced by the lax twin or the host emulation of the
kernels (the ``cuda_twin`` fixture, tests/conftest.py)."""

import numpy as np
import pytest

from genomax import native
from genomax.config import EngineConfig
from genomax.engine.executor import Engine
from genomax.io.formats import PairHMMRead, SWPair
from genomax.io.generator import generate_pairhmm_batch
from genomax.kernels import oracle

_ABC = np.frombuffer(b"ATGC", np.uint8)
_LADDER_OFF = dict(stream_band_transfer=False, nibble_transfer=False,
                   factored_transfer=False)
_LADDER_ON = dict(stream_band_transfer=True, nibble_transfer=True,
                  factored_transfer=True)


def _ragged_pairs(seed=12):
    """Lengths spanning several buckets, shuffled so that the unpack must
    restore the input order."""
    rng = np.random.default_rng(seed)
    pairs = []
    for lo, hi, n in ((1, 20, 40), (60, 130, 30), (200, 300, 10)):
        for _ in range(n):
            a = rng.choice(_ABC, int(rng.integers(lo, hi))).tobytes()
            b = rng.choice(_ABC, int(rng.integers(lo, hi))).tobytes()
            pairs.append(SWPair(sx=a + b"\n", sy=b + b"\n"))
    rng.shuffle(pairs)
    return pairs


def test_cuda_path_sw_ragged_buckets(cuda_twin):
    pairs = _ragged_pairs()
    eng = Engine(EngineConfig(backend="cuda"))
    assert eng.backend == "cuda"
    np.testing.assert_array_equal(eng.sw_scores(pairs),
                                  oracle.sw_scores_pairs(pairs))
    assert eng.last_stats.buckets >= 3
    assert eng.last_stats.offloaded_jobs == 0


def test_cuda_path_sw_long_pairs_offload_to_native(cuda_twin):
    """x past the kernel's reach (or max_device_len) goes to the native
    model, counted in offloaded_jobs; the rest stays on the device."""
    rng = np.random.default_rng(13)
    pairs = [SWPair(sx=rng.choice(_ABC, 30).tobytes(),
                    sy=rng.choice(_ABC, 40).tobytes()) for _ in range(5)]
    pairs.insert(2, SWPair(sx=rng.choice(_ABC, 1100).tobytes(),
                           sy=rng.choice(_ABC, 900).tobytes()))
    eng = Engine(EngineConfig(backend="cuda"))
    got = eng.sw_scores(pairs)
    assert eng.last_stats.offloaded_jobs == 1
    np.testing.assert_array_equal(got, native.sw_scores_native(pairs))


def test_cuda_path_pairhmm_offload_and_fallback(cuda_twin):
    """Reads past the device bound take the native offload, deep results
    the fp64 fallback; every value matches the fp64 model."""
    batch = generate_pairhmm_batch(3, 2, read_len=25, hap_len=37, seed=14,
                                   from_haps=True)
    q = bytes([33 + 40] * 120)
    batch.reads.append(PairHMMRead(bases=b"A" * 120, base_q=q, ins_q=q,
                                   del_q=q, gcp_q=q))  # deep: < -45
    q = bytes([33 + 30] * 600)
    batch.reads.append(PairHMMRead(
        bases=np.random.default_rng(1).choice(_ABC, 600).tobytes(),
        base_q=q, ins_q=q, del_q=q, gcp_q=q))  # past the device bound
    batch.haplotypes.append(b"C" * 80)
    eng = Engine(EngineConfig(backend="cuda"))
    got = eng.pairhmm([batch])
    assert eng.last_stats.offloaded_jobs == 3
    assert eng.last_stats.fallback_jobs >= 1
    np.testing.assert_allclose(got, native.pairhmm_native([batch]),
                               atol=2e-4)


@pytest.mark.parametrize("ladder", [_LADDER_OFF, _LADDER_ON],
                         ids=["ladder_off", "ladder_on"])
def test_cuda_path_transfer_ladder(cuda_twin, ladder):
    """Every rung of the transfer ladder is bit-exact: scores with the
    rungs on equal the oracle and the lax engine, rungs off likewise."""
    pairs = _ragged_pairs(15)[:60]
    batch = generate_pairhmm_batch(6, 3, read_len=31, hap_len=44, seed=16)
    eng = Engine(EngineConfig(backend="cuda", **ladder))
    np.testing.assert_array_equal(eng.sw_scores(pairs),
                                  oracle.sw_scores_pairs(pairs))
    lax = Engine(EngineConfig(backend="lax")).pairhmm([batch])
    np.testing.assert_allclose(eng.pairhmm([batch]), lax, atol=1e-5)


def test_cuda_path_stream_matches_oneshot(cuda_twin):
    """The chunked streaming driver over the cuda path equals one shot."""
    pairs = _ragged_pairs(17)[:50]
    eng = Engine(EngineConfig(backend="cuda"))
    np.testing.assert_array_equal(eng.sw_scores_stream(pairs, 16),
                                  eng.sw_scores(pairs))
    batches = [generate_pairhmm_batch(2, 2, read_len=12 + i, hap_len=20,
                                      seed=i) for i in range(3)]
    np.testing.assert_allclose(eng.pairhmm_stream(batches, 2),
                               eng.pairhmm(batches), atol=1e-6)
