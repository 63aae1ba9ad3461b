"""Native C++ golden library: build + differential tests vs the python
oracle and the vendored reference outputs."""

import os

import numpy as np
import pytest

from genomax import native
from genomax.io.formats import parse_pairhmm_file, parse_sw_file

G = os.path.join(os.path.dirname(__file__), "golden")

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain for the native golden lib"
)


def test_native_sw_matches_reference_outputs():
    for name in ("sw_quirks", "sw_small", "sw_medium"):
        pairs = parse_sw_file(os.path.join(G, f"{name}.in"))
        got = native.sw_scores_native(pairs)
        want = np.array(
            [int(l.split()[1]) for l in open(os.path.join(G, f"{name}.golden.out"))]
        )
        np.testing.assert_array_equal(got, want)


def test_native_pairhmm_matches_reference_outputs():
    v = native.pairhmm_native(parse_pairhmm_file(os.path.join(G, "test.in")))
    want = float(open(os.path.join(G, "test.out")).read())
    assert abs(v[0] - want) < 5e-7

    v = native.pairhmm_native(parse_pairhmm_file(os.path.join(G, "10s.in")))
    want = np.array([float(l) for l in open(os.path.join(G, "10s.golden.out"))])
    # reference output is %f-rounded to 6 decimals
    assert np.abs(v - want).max() < 1e-6


def test_native_vs_python_oracle_random():
    from genomax.io.generator import generate_pairhmm_batch
    from genomax.kernels import oracle

    batch = generate_pairhmm_batch(2, 2, read_len=15, hap_len=21, seed=77)
    got = native.pairhmm_native([batch])
    want = oracle.pairhmm_batch_log10(batch)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_native_pack_fill_matches_python(monkeypatch):
    """The C++ data-loader fill and the pure-python fill must produce
    byte-identical packed buckets."""
    import genomax.native as native
    from genomax.io.generator import generate_pairhmm_batch
    from genomax.io.formats import SWPair
    from genomax.pack import bucketing

    if not native.available():
        pytest.skip("native unavailable")

    rng = np.random.default_rng(77)
    pairs = []
    for _ in range(40):
        a = rng.choice(list(b"ATGCN\n"), int(rng.integers(1, 60))).astype(np.uint8).tobytes()
        b = rng.choice(list(b"ATGCN\n"), int(rng.integers(1, 60))).astype(np.uint8).tobytes()
        if len(a) > len(b):
            a, b = b, a
        pairs.append(SWPair(sx=a, sy=b))
    batch = generate_pairhmm_batch(5, 3, read_len=33, hap_len=47, seed=7)

    nat_sw = bucketing.pack_sw_pairs(pairs)
    nat_ph, _ = bucketing.pack_pairhmm_batches([batch])
    monkeypatch.setattr(native, "load", lambda rebuild=False: None)
    py_sw = bucketing.pack_sw_pairs(pairs)
    py_ph, _ = bucketing.pack_pairhmm_batches([batch])

    import dataclasses
    for a_, b_ in zip(nat_sw + nat_ph, py_sw + py_ph):
        for f in dataclasses.fields(a_):
            va, vb = getattr(a_, f.name), getattr(b_, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name


def test_byte_qual_pack_native_matches_python(monkeypatch):
    """byte_quals mode: the C++ byte fill and the pure-python fill must
    produce byte-identical packs (qb planes included)."""
    import dataclasses

    import genomax.native as native
    from genomax.io.generator import generate_pairhmm_batch
    from genomax.pack import bucketing

    if not native.available():
        pytest.skip("native unavailable")

    batch = generate_pairhmm_batch(7, 3, read_len=29, hap_len=53, seed=11)
    nat_ph, _ = bucketing.pack_pairhmm_batches([batch], byte_quals=True)
    monkeypatch.setattr(native, "load", lambda rebuild=False: None)
    py_ph, _ = bucketing.pack_pairhmm_batches([batch], byte_quals=True)
    for a_, b_ in zip(nat_ph, py_ph):
        assert a_.qb is not None and b_.qb is not None
        assert a_.qr is None and b_.qr is None
        for f in dataclasses.fields(a_):
            va, vb = getattr(a_, f.name), getattr(b_, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name


def test_expand_byte_quals_matches_fp32_pack():
    """Device-side expansion of raw phred bytes must reproduce the host
    fp32 qual tables: exact for the four LUT lookups (same fp64 value
    cast to fp32), <=1-ulp for the fp32-summed mmv/gapm, exact 0.0 at
    every pad cell (the pad-decay invariant)."""
    from genomax.io.generator import generate_pairhmm_batch
    from genomax.pack.expand import expand_byte_quals
    from genomax.pack import bucketing

    batch = generate_pairhmm_batch(9, 2, read_len=41, hap_len=60, seed=3)
    fp, _ = bucketing.pack_pairhmm_batches([batch])
    by, _ = bucketing.pack_pairhmm_batches([batch], byte_quals=True)
    for bf, bb in zip(fp, by):
        qr, mmv, gapm, qi, qd, qg = (
            np.asarray(a) for a in expand_byte_quals(bb.qb)
        )
        np.testing.assert_array_equal(qr, bf.qr)
        np.testing.assert_array_equal(qi, bf.qi)
        np.testing.assert_array_equal(qd, bf.qd)
        np.testing.assert_array_equal(qg, bf.qg)
        np.testing.assert_allclose(mmv, bf.mmv, rtol=2e-7, atol=0)
        np.testing.assert_allclose(gapm, bf.gapm, rtol=2e-7, atol=0)
        pad = bf.qr == 0.0
        for arr in (mmv, gapm):
            assert (arr[pad] == 0.0).all()


def test_pairhmm_native_rejects_mismatched_quals():
    """gx_pairhmm_batch indexes the flat qual arrays with the BASES
    offsets, so a read whose qual strings are shorter than its bases
    would read past the allocation — the public entry point must reject
    it loudly like the packers do (round-3 self-review finding)."""
    import pytest

    from genomax import native
    from genomax.io.formats import PairHMMBatch, PairHMMRead

    rd = PairHMMRead(bases=b"ACGT" * 10, base_q=b"I" * 8, ins_q=b"I" * 8,
                     del_q=b"I" * 8, gcp_q=b"I" * 8)
    with pytest.raises(ValueError, match="quality strings"):
        native.pairhmm_native([PairHMMBatch(reads=[rd],
                                            haplotypes=[b"ACGTA"])])
