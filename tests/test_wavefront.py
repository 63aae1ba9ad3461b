"""Differential tests: the shared wavefront step math (lax backend) vs the
independent full-matrix numpy oracle, on random ragged inputs — the
automated version of the reference's matrix-vs-antidiagonal differential
testing (README.md:2, SURVEY.md §4)."""

import numpy as np
import pytest

from genomax.config import EngineConfig
from genomax.engine.executor import Engine
from genomax.io.formats import SWPair
from genomax.io.generator import generate_pairhmm_batch
from genomax.kernels import oracle


@pytest.fixture(scope="module")
def eng():
    return Engine(EngineConfig(backend="lax"))


def _random_pairs(rng, n, lo, hi, alphabet=b"ATGC", newline=True):
    out = []
    for _ in range(n):
        a = rng.choice(list(alphabet), size=int(rng.integers(lo, hi))).astype(np.uint8)
        bseq = rng.choice(list(alphabet), size=int(rng.integers(lo, hi))).astype(np.uint8)
        a, bseq = a.tobytes(), bseq.tobytes()
        if newline:
            a += b"\n"
            bseq += b"\n"
        if len(a) > len(bseq):
            a, bseq = bseq, a
        out.append(SWPair(sx=a, sy=bseq))
    return out


def test_sw_random_vs_oracle(eng):
    rng = np.random.default_rng(7)
    pairs = _random_pairs(rng, 24, 1, 40)
    got = eng.sw_scores(pairs)
    want = oracle.sw_scores_pairs(pairs)
    np.testing.assert_array_equal(got, want)


def test_sw_ragged_mixed_lengths(eng):
    rng = np.random.default_rng(8)
    # spans two lane buckets; exercises per-pair masking inside one tile
    pairs = _random_pairs(rng, 10, 1, 30) + _random_pairs(rng, 6, 120, 180)
    got = eng.sw_scores(pairs)
    want = oracle.sw_scores_pairs(pairs)
    np.testing.assert_array_equal(got, want)


def test_sw_empty_and_single(eng):
    pairs = [SWPair(sx=b"", sy=b""), SWPair(sx=b"A", sy=b"A"), SWPair(sx=b"A", sy=b"T")]
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, [0, 1, 0])


def test_pairhmm_random_vs_oracle(eng):
    batch = generate_pairhmm_batch(3, 2, read_len=25, hap_len=33, seed=3)
    got = eng.pairhmm([batch])
    want = oracle.pairhmm_batch_log10(batch)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_pairhmm_n_bases_match_everything(eng):
    batch = generate_pairhmm_batch(1, 1, read_len=12, hap_len=16, seed=5)
    batch.reads[0].bases = b"N" * 12
    got = eng.pairhmm([batch])
    want = oracle.pairhmm_batch_log10(batch)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_pairhmm_multi_batch_order(eng):
    b1 = generate_pairhmm_batch(2, 2, read_len=11, hap_len=14, seed=11)
    b2 = generate_pairhmm_batch(1, 3, read_len=17, hap_len=9, seed=12)
    got = eng.pairhmm([b1, b2])
    want = np.concatenate(
        [oracle.pairhmm_batch_log10(b1), oracle.pairhmm_batch_log10(b2)]
    )
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_pairhmm_deep_decay_rescale():
    # Force heavy mismatch decay to exercise the exponent-rescale path:
    # all-mismatch read with strong base quality => per-row attenuation
    # ~1e-4, total ~1e-4*rl, well past fp32 range without rescaling.
    # Fallback disabled so the fp32 path itself is what's verified.
    eng = Engine(
        EngineConfig(backend="lax", phmm_fallback_threshold=None)
    )
    batch = generate_pairhmm_batch(1, 1, read_len=60, hap_len=70, seed=21)
    batch.reads[0].bases = b"A" * 60
    batch.haplotypes[0] = b"C" * 70
    got = eng.pairhmm([batch])
    want = oracle.pairhmm_batch_log10(batch)
    # Proves the case needs rescaling: the diagonal peak decays by
    # ~|want| orders below the 2**120 init, far past the 2**40 trigger.
    assert want[0] < -40
    np.testing.assert_allclose(got, want, atol=5e-3)


def _tandem_pairs():
    """Adversarial wrap-around workload: y contains a second copy of x
    roughly NXs rows later, so the bottom row's accumulated D/Q wrap into
    row 0 of the circular roll exactly when a fresh high-scoring region
    starts there. Without the boundary-row pins these inflate (193 vs 100
    before the pins)."""
    rng = np.random.default_rng(42)
    abc = np.frombuffer(b"ATGC", np.uint8)
    out = []
    for xlen, gap in [(100, 104), (100, 60), (100, 160), (37, 40),
                      (250, 256), (250, 1000)]:
        x = rng.choice(abc, xlen).tobytes()
        junk = rng.choice(abc, gap).tobytes()
        out.append(SWPair(sx=x, sy=x + junk + x))
        # triple repeat: two wrap generations
        out.append(SWPair(sx=x, sy=x + junk + x + junk + x))
    return out


def test_sw_tandem_repeat_wraparound(eng):
    pairs = _tandem_pairs()
    np.testing.assert_array_equal(
        eng.sw_scores(pairs), oracle.sw_scores_pairs(pairs)
    )


def test_pairhmm_n_run_haplotype_wraparound(eng):
    """'N' runs in the haplotype make every row's emission match-all;
    combined with a second read-similar region they are the PairHMM
    analog of the SW tandem-repeat wrap trigger. The packed-zero
    transition constants (and the pm dead-row pin) must keep pad rows
    opaque so nothing survives the circular roll."""
    rng = np.random.default_rng(9)
    abc = np.frombuffer(b"ACGT", np.uint8)
    L = 120
    bases = rng.choice(abc, L).tobytes()
    q = bytes([40] * L)
    from genomax.io.formats import PairHMMBatch, PairHMMRead

    rd = PairHMMRead(bases=bases, base_q=q, ins_q=q, del_q=q, gcp_q=q)
    haps = [
        rng.choice(abc, 60).tobytes() + b"N" * 200 + bases + b"N" * 100,
        b"N" * 500,
        bases + b"N" * 130 + bases,
    ]
    batch = PairHMMBatch(reads=[rd], haplotypes=haps)
    e = Engine(EngineConfig(backend="lax", phmm_fallback_threshold=None))
    got = e.pairhmm([batch])
    want = oracle.pairhmm_batch_log10(batch)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_sw_random_scoring_configs_vs_oracle():
    """The mask-free formulation must hold across the whole supported
    scoring domain (match>0, mismatch<0, open<=0, extend<0), including
    extend > open and zero gap-open."""
    from genomax.config import SWConfig

    rng = np.random.default_rng(0)
    cfgs = [SWConfig(match=2, mismatch=-3, gap_open=0, gap_extend=-1)]
    for _ in range(3):
        cfgs.append(SWConfig(
            match=int(rng.integers(1, 6)),
            mismatch=-int(rng.integers(1, 6)),
            gap_open=-int(rng.integers(0, 8)),
            gap_extend=-int(rng.integers(1, 5)),
        ))
    for cfg in cfgs:
        pairs = _random_pairs(rng, 6, 1, 35)
        e = Engine(EngineConfig(backend="lax"), sw_cfg=cfg)
        np.testing.assert_array_equal(
            e.sw_scores(pairs), oracle.sw_scores_pairs(pairs, cfg),
            err_msg=str(cfg),
        )


def test_sw_invalid_scoring_rejected():
    from genomax.config import SWConfig

    with pytest.raises(ValueError):
        Engine(EngineConfig(backend="lax"), sw_cfg=SWConfig(mismatch=1))
    with pytest.raises(ValueError):
        Engine(EngineConfig(backend="lax"), sw_cfg=SWConfig(gap_extend=0))


def test_pairhmm_gatk_emission_mode():
    """PairHMMConfig.gatk_emission=True applies the true GATK Qr/3
    mismatch emission consistently across the lax kernel, the fp64
    oracle, and the native model — and actually changes mismatch-heavy
    results vs the reference-parity default."""
    from genomax import native
    from genomax.config import EngineConfig, PairHMMConfig

    batch = generate_pairhmm_batch(2, 2, read_len=21, hap_len=27, seed=15)
    cfg = PairHMMConfig(gatk_emission=True)
    eng = Engine(EngineConfig(backend="lax"), phmm_cfg=cfg)
    got = eng.pairhmm([batch])
    want = oracle.pairhmm_batch_log10(batch, cfg)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # differs from reference-parity mode (random pairs mismatch a lot)
    ref = oracle.pairhmm_batch_log10(batch)
    assert np.abs(want - ref).max() > 0.1
    if native.available():
        np.testing.assert_allclose(
            native.pairhmm_native([batch], gatk_emission=True), want,
            atol=1e-9)


def test_pairhmm_bitmask_translation_and_fallback(eng):
    """Packs whose alphabet is ACGTN translate to one-hot match-bitmask
    codes (bitmask_codes=True, one and+compare emission); any other byte
    forces the exact byte-equality path (False). Both must match the
    byte-semantics oracle."""
    from genomax.pack.bucketing import pack_pairhmm_batches

    batch = generate_pairhmm_batch(2, 2, read_len=14, hap_len=18, seed=21)
    bks, _ = pack_pairhmm_batches([batch], bitmask_codes=True)
    assert all(b.bitmask_codes for b in bks)
    # translation is opt-in: a default pack keeps raw byte codes, so
    # direct kernel consumers (kernels default bitmask=False) stay exact
    raw, _ = pack_pairhmm_batches([batch])
    assert not any(b.bitmask_codes for b in raw)
    got = eng.pairhmm([batch])
    np.testing.assert_allclose(got, oracle.pairhmm_batch_log10(batch),
                               atol=2e-4)

    # 'X' in a read and a hap: exact byte-equality semantics (X matches
    # X, nothing else) must be preserved via the fallback path.
    weird = generate_pairhmm_batch(2, 2, read_len=14, hap_len=18, seed=22)
    weird.reads[0].bases = b"AX" + weird.reads[0].bases[2:]
    weird.haplotypes[0] = b"XA" + weird.haplotypes[0][2:]
    bks, _ = pack_pairhmm_batches([weird], bitmask_codes=True)
    assert not any(b.bitmask_codes for b in bks)
    got = eng.pairhmm([weird])
    np.testing.assert_allclose(got, oracle.pairhmm_batch_log10(weird),
                               atol=2e-4)


def test_default_pack_keeps_n_wildcard_for_direct_consumers():
    """The bitmask translation is opt-in: a DIRECT consumer of a default
    pack + a kernel left at its default (bitmask=False) must still get
    the reference's N-wildcard semantics. Before the opt-in gate, the
    pack silently rewrote 'N' to code 15, the byte-mode wildcard compare
    (== 'N' == 78) never fired, and N-containing data mis-scored."""
    from genomax.engine.executor import flatten_tiles
    from genomax.kernels.wavefront import phmm_forward_dense
    from genomax.pack.bucketing import pack_pairhmm_batches

    batch = generate_pairhmm_batch(2, 2, read_len=16, hap_len=20, seed=30)
    batch.reads[0].bases = b"NN" + batch.reads[0].bases[2:]
    batch.haplotypes[0] = b"NA" + batch.haplotypes[0][2:]
    (b,), _ = pack_pairhmm_batches([batch])
    assert not b.bitmask_codes
    got = np.asarray(phmm_forward_dense(
        flatten_tiles(b.rchar), flatten_tiles(b.qr), flatten_tiles(b.mmv),
        flatten_tiles(b.gapm), flatten_tiles(b.qi), flatten_tiles(b.qd),
        flatten_tiles(b.qg), flatten_tiles(b.hap),
        np.asarray(b.rl), np.asarray(b.hl), n_diags=b.max_diags,
    )).reshape(-1)[: b.n_valid]
    want = oracle.pairhmm_batch_log10(batch)
    out = np.zeros_like(want)
    out[b.perm] = got
    np.testing.assert_allclose(out, want, atol=2e-4)


def test_sw_forward_dense_widens_int8_tiles():
    """The dense twin must accept the packs' natural int8 tiles: the DP
    state and -KILL boundary consts inherit the input dtype, so int8
    would wrap KILL=2**28 to 0 and overflow scores at 127 (round-3
    self-review finding)."""
    import jax.numpy as jnp

    from genomax.io.formats import SWPair
    from genomax.kernels.wavefront import sw_forward_dense
    from genomax.pack.bucketing import pack_sw_pairs

    rng = np.random.default_rng(3)
    abc = np.frombuffer(b"ATGC", np.uint8)
    pairs = [SWPair(sx=rng.choice(abc, 40).tobytes() + b"\n",
                    sy=rng.choice(abc, 70).tobytes() + b"\n")
             for _ in range(6)]
    b = pack_sw_pairs(pairs)[0]
    sx8 = jnp.asarray(b.sx[0])          # int8, as packed
    sy8 = jnp.asarray(b.sy[0])
    got = np.asarray(sw_forward_dense(sx8, sy8, None, None,
                                      int(b.ndiag_tile[0])))
    out = np.zeros(len(pairs), np.int32)
    out[b.perm] = got[: b.n_valid]
    np.testing.assert_array_equal(out, oracle.sw_scores_pairs(pairs))
