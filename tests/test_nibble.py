"""Nibble-compressed SW transfer (pack/nibble.py): bit-exact expansion,
alphabet gating, and score-invariance through the engine."""

import numpy as np
import pytest

from genomax.pack.nibble import build_code_lut, expand_nibbles, nibble_pack


def _tiles(rng, nt, r, alphabet):
    a = rng.choice(alphabet, size=(nt, r, 128)).astype(np.int8)
    a[:, 0] = 1  # sprinkle the pad codes like real tiles do
    a[:, -1] = 0
    return a


def test_roundtrip_bitexact_even_and_odd_rows():
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGTN\n", np.uint8)
    for r in (8, 13):  # even and odd row counts
        arr = _tiles(rng, 3, r, alphabet)
        lut = build_code_lut(arr)
        assert lut is not None
        got = np.asarray(expand_nibbles(nibble_pack(arr, lut), r))
        np.testing.assert_array_equal(got, lut[arr.view(np.uint8)].astype(np.int8))
        assert got.shape == arr.shape


def test_lut_shared_alphabet_and_pad_fixed():
    rng = np.random.default_rng(1)
    a = _tiles(rng, 2, 16, np.frombuffer(b"ACGT", np.uint8))
    b = _tiles(rng, 2, 24, np.frombuffer(b"GTN\n", np.uint8))
    lut = build_code_lut(a, b)
    assert lut is not None
    assert lut[0] == 0 and lut[1] == 1
    # bijective on the union alphabet, into 2..15
    syms = np.unique(np.concatenate([a.reshape(-1), b.reshape(-1)]))
    syms = syms[(syms != 0) & (syms != 1)].view(np.uint8)
    codes = lut[syms]
    assert len(np.unique(codes)) == len(syms)
    assert codes.min() >= 2 and codes.max() <= 15


def test_alphabet_too_wide_returns_none():
    arr = np.arange(2, 20, dtype=np.int8).reshape(1, 18, 1) * np.ones(
        (1, 18, 128), np.int8
    )
    assert build_code_lut(arr) is None


@pytest.mark.parametrize("lengths", [(40, 64), (3, 200)])
def test_engine_scores_invariant_under_nibble_transfer(lengths, cuda_twin):
    """The cuda engine path (kernels replaced by their CPU twins) with
    nibble_transfer on == off, on a workload that includes the
    trailing-'\\n' quirk bytes."""
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine
    from genomax.io.formats import SWPair
    from genomax.io.generator import random_dna

    rng = np.random.default_rng(7)
    lo, hi = lengths
    pairs = []
    for i in range(40):
        sx = random_dna(rng, int(rng.integers(lo, hi)))
        sy = random_dna(rng, int(rng.integers(lo, hi)))
        if i % 3 == 0:  # the reference keeps the trailing newline
            sx, sy = sx + b"\n", sy + b"\n"
        pairs.append(SWPair(sx=sx, sy=sy))
    on = Engine(
        EngineConfig(backend="cuda", nibble_transfer=True)
    ).sw_scores(pairs)
    off = Engine(
        EngineConfig(backend="cuda", nibble_transfer=False)
    ).sw_scores(pairs)
    np.testing.assert_array_equal(on, off)


def test_nibble_pack_4bit_guards_wide_values():
    from genomax.pack.nibble import nibble_pack_4bit

    arr = np.full((1, 4, 128), 15, np.int8)
    assert nibble_pack_4bit(arr).shape == (1, 2, 128)
    arr[0, 1, 3] = 16
    with pytest.raises(ValueError):
        nibble_pack_4bit(arr)


def test_engine_pairhmm_invariant_under_nibble_transfer(cuda_twin):
    """Bitmask-coded PairHMM pack: rchar/hap nibble shipping must be
    bit-exact (identical log10s, not just close)."""
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine
    from genomax.io.generator import generate_pairhmm_batch

    batch = generate_pairhmm_batch(6, 3, read_len=23, hap_len=31, seed=5)
    on = Engine(
        EngineConfig(backend="cuda", nibble_transfer=True)
    ).pairhmm([batch])
    off = Engine(
        EngineConfig(backend="cuda", nibble_transfer=False)
    ).pairhmm([batch])
    np.testing.assert_array_equal(on, off)


def test_sharded_engine_invariant_under_nibble_transfer(cuda_twin):
    """Mesh paths: nibble shipping + post-placement expansion inside the
    sharded dispatch (SW and PairHMM) must not change results."""
    from genomax.config import EngineConfig
    from genomax.dist.engine import ShardedEngine
    from genomax.dist.mesh import make_mesh
    from genomax.io.formats import SWPair
    from genomax.io.generator import generate_pairhmm_batch, random_dna

    mesh = make_mesh(2)
    rng = np.random.default_rng(11)
    pairs = [
        SWPair(sx=random_dna(rng, 50), sy=random_dna(rng, 61))
        for _ in range(10)
    ]
    batch = generate_pairhmm_batch(4, 2, read_len=19, hap_len=27, seed=2)
    res = {}
    for flag in (True, False):
        eng = ShardedEngine(
            mesh,
            EngineConfig(backend="cuda", nibble_transfer=flag),
        )
        res[flag] = (eng.sw_scores(pairs), eng.pairhmm([batch]))
    np.testing.assert_array_equal(res[True][0], res[False][0])
    np.testing.assert_array_equal(res[True][1], res[False][1])


def test_engine_wide_alphabet_falls_back_uncompressed(cuda_twin):
    """>14 distinct symbols: build_code_lut declines, the engine ships
    raw bytes, and scores still match the oracle."""
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine
    from genomax.io.formats import SWPair
    from genomax.kernels import oracle

    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ABCDEFGHIJKLMNOPQR", np.uint8)  # 18 symbols
    pairs = [
        SWPair(
            sx=rng.choice(alpha, 30).astype(np.uint8).tobytes(),
            sy=rng.choice(alpha, 33).astype(np.uint8).tobytes(),
        )
        for _ in range(9)
    ]
    got = Engine(
        EngineConfig(backend="cuda", nibble_transfer=True)
    ).sw_scores(pairs)
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(pairs))


def test_stream_band_pack_bit_identical():
    """stream_band=True packs only the live rows; materialize() and the
    device reconstruct (ship_stream) must both be byte-identical to the
    full pack — the invariant that lets every kernel stay untouched."""
    import jax.numpy as jnp

    from genomax.io.formats import SWPair
    from genomax.pack.bucketing import StreamBand, pack_sw_pairs
    from genomax.pack.nibble import build_code_lut, make_shipper, ship_stream

    rng = np.random.default_rng(17)
    pairs = []
    for _ in range(140):  # >1 tile, ragged lengths
        a = rng.choice(list(b"ATGC"), int(rng.integers(3, 90))).astype(np.uint8).tobytes()
        b = rng.choice(list(b"ATGC"), int(rng.integers(3, 200))).astype(np.uint8).tobytes()
        if len(a) > len(b):
            a, b = b, a
        pairs.append(SWPair(sx=a + b"\n", sy=b + b"\n"))
    full = pack_sw_pairs(pairs)
    band = pack_sw_pairs(pairs, stream_band=True)
    assert len(full) == len(band)
    for bf, bb in zip(full, band):
        assert isinstance(bb.sy, StreamBand)
        assert bb.sy.shape == bf.sy.shape
        # the band is a real saving, not the whole buffer renamed
        assert bb.sy.band.shape[1] < bf.sy.shape[1]
        np.testing.assert_array_equal(bb.sy.materialize(), bf.sy)
        np.testing.assert_array_equal(bb.sx, bf.sx)
        np.testing.assert_array_equal(bb.ndiag_tile, bf.ndiag_tile)
        # device reconstruct, raw and through the nibble shipper
        np.testing.assert_array_equal(
            np.asarray(ship_stream(jnp.asarray, bb.sy)), bf.sy)
        lut = build_code_lut(bb.sx, bb.sy.band)
        ship = make_shipper(jnp.asarray, lut=lut)
        want = np.asarray(ship(bf.sy))  # full buffer through the same lut
        np.testing.assert_array_equal(
            np.asarray(ship_stream(ship, bb.sy)), want)


def test_engine_stream_band_end_to_end(cuda_twin):
    """The cuda engine path with the (default-on) band transfer must
    match the oracle — and actually route through StreamBand."""
    from genomax.config import EngineConfig
    from genomax.engine.executor import Engine
    from genomax.io.formats import SWPair
    from genomax.kernels import oracle

    rng = np.random.default_rng(18)
    pairs = []
    for _ in range(20):
        a = rng.choice(list(b"ATGC"), int(rng.integers(5, 160))).astype(np.uint8).tobytes()
        b = rng.choice(list(b"ATGC"), int(rng.integers(5, 160))).astype(np.uint8).tobytes()
        if len(a) > len(b):
            a, b = b, a
        pairs.append(SWPair(sx=a, sy=b))
    eng = Engine(EngineConfig(backend="cuda"))
    assert eng._stream_band()
    got = eng.sw_scores(pairs)
    np.testing.assert_array_equal(got, oracle.sw_scores_pairs(pairs))
