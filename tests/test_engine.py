"""Engine-level tests: golden parity, stats, fp64 fallback."""

import os

import numpy as np
import pytest

from genomax.config import EngineConfig
from genomax.engine.executor import Engine
from genomax.io.formats import parse_pairhmm_file, parse_sw_file
from genomax.io.generator import generate_pairhmm_batch

G = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def eng():
    return Engine(EngineConfig(backend="lax"))


def test_sw_goldens(eng):
    for name in ("sw_quirks", "sw_small"):
        got = eng.sw_scores(parse_sw_file(os.path.join(G, f"{name}.in")))
        want = np.array(
            [int(l.split()[1]) for l in open(os.path.join(G, f"{name}.golden.out"))]
        )
        np.testing.assert_array_equal(got, want)


def test_pairhmm_golden_test_in(eng):
    v = eng.pairhmm(parse_pairhmm_file(os.path.join(G, "test.in")))
    want = float(open(os.path.join(G, "test.out")).read())
    assert abs(v[0] - want) < 1e-4
    assert eng.last_stats.n_jobs == 1


def test_stats_populated(eng):
    eng.pairhmm(parse_pairhmm_file(os.path.join(G, "test.in")))
    s = eng.last_stats.as_dict()
    assert s["dp_cells"] == 41 * 41
    assert s["buckets"] == 1
    assert s["exec_s"] > 0


def test_fallback_exact_for_out_of_range_pairs():
    from genomax import native

    if not native.available():
        pytest.skip("native golden unavailable")
    eng = Engine(EngineConfig(backend="lax"))
    # unrelated read/hap: true log10 likelihood far below the fp32 design
    # range; the engine must hand these to the fp64 golden model.
    batch = generate_pairhmm_batch(1, 1, read_len=120, hap_len=130, seed=99)
    got = eng.pairhmm([batch])
    want = native.pairhmm_native([batch])
    assert want[0] < -100
    assert eng.last_stats.fallback_jobs == 1
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_oversized_pairs_offload_to_native():
    """Pairs past the device bound run through the native exact model —
    the reference supports up to MAX_LINE_LENGTH 1000 sequences; we go far
    beyond."""
    from genomax import native
    from genomax.io.formats import SWPair

    if not native.available():
        pytest.skip("native golden unavailable")
    rng = np.random.default_rng(5)
    long_a = rng.choice(list(b"ATGC"), size=3000).astype(np.uint8).tobytes()
    long_b = rng.choice(list(b"ATGC"), size=3100).astype(np.uint8).tobytes()
    short = [
        SWPair(sx=rng.choice(list(b"ATGC"), 20).astype(np.uint8).tobytes(),
               sy=rng.choice(list(b"ATGC"), 25).astype(np.uint8).tobytes())
        for _ in range(3)
    ]
    pairs = [short[0], SWPair(sx=long_a, sy=long_b), short[1], short[2]]
    eng = Engine(EngineConfig(backend="lax"))
    got = eng.sw_scores(pairs)
    assert eng.last_stats.offloaded_jobs == 1
    want = native.sw_scores_native(pairs)
    np.testing.assert_array_equal(got, want)


def test_oversized_pairhmm_offload():
    from genomax import native
    from genomax.io.generator import generate_pairhmm_batch
    from genomax.kernels import oracle

    if not native.available():
        pytest.skip("native golden unavailable")
    big = generate_pairhmm_batch(1, 1, read_len=1200, hap_len=1300, seed=6)
    small = generate_pairhmm_batch(2, 1, read_len=12, hap_len=15, seed=7)
    eng = Engine(EngineConfig(backend="lax"))
    got = eng.pairhmm([small, big])
    assert eng.last_stats.offloaded_jobs == 1
    want_small = oracle.pairhmm_batch_log10(small)
    np.testing.assert_allclose(got[:2], want_small, atol=2e-4)
    want_big = native.pairhmm_native([big])
    np.testing.assert_allclose(got[2], want_big[0], atol=1e-9)


def test_compilation_cache_config_wiring(monkeypatch):
    """Without $JAX_COMPILATION_CACHE_DIR, setup_compilation_cache puts
    the persistent cache in the checkout's own directory (listed in
    .gitignore)."""
    import genomax
    import jax

    monkeypatch.setattr(genomax, "_CACHE_SET_UP", False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        genomax.setup_compilation_cache()
        want = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
        assert genomax.compilation_cache_dir() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compilation_cache_respects_env(monkeypatch, tmp_path):
    """With $JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it wins:
    setup_compilation_cache sets no directory."""
    import genomax
    import jax

    monkeypatch.setattr(genomax, "_CACHE_SET_UP", False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "/unchanged")
        genomax.setup_compilation_cache()
        assert genomax.compilation_cache_dir() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "/unchanged"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_engine_error_names_stage_and_bucket():
    """A failing bucket surfaces as EngineError with stage, bucket index
    and shape (the reference never checks its kernel error flag)."""
    from genomax.engine.executor import EngineError, _run_buckets
    from genomax.io.formats import SWPair
    from genomax.pack.bucketing import pack_sw_pairs

    buckets = pack_sw_pairs([SWPair(sx=b"ACGT", sy=b"ACG")])

    def boom(b):
        raise RuntimeError("device failure")

    with pytest.raises(EngineError, match="sw failed on bucket 0") as e:
        _run_buckets("sw", buckets, boom)
    assert e.value.stage == "sw" and e.value.bucket == 0


def test_pairhmm_out_of_range_quals_rejected():
    """Quality bytes below the phred offset (decode to error prob > 1)
    or above 127 (wrap negative through the reference's signed char)
    must be rejected loudly at pack time: the byte-shipping device path
    and the fp32-table path would otherwise decode them differently and
    silently diverge (round-3 self-review finding)."""
    from genomax.io.formats import PairHMMBatch, PairHMMRead
    from genomax.pack.bucketing import pack_pairhmm_batches

    def batch(q):
        rd = PairHMMRead(bases=b"ACGT", base_q=q, ins_q=b"IIII",
                         del_q=b"IIII", gcp_q=b"++++")
        return PairHMMBatch(reads=[rd], haplotypes=[b"ACGTA"])

    for bad in (b"I\x20II", b"II\xffI"):
        with pytest.raises(ValueError, match="quality byte out of range"):
            pack_pairhmm_batches([batch(bad)])
    for bad in (b"I\x20II", b"II\xffI"):
        with pytest.raises(ValueError, match="quality byte out of range"):
            pack_pairhmm_batches([batch(bad)], factored=True)
    # boundary values are legal
    pack_pairhmm_batches([batch(b"!!\x7f!")])
