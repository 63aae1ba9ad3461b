"""Factored PairHMM transfer (PairHMMPacked.rchar_u/qb_u/hap_u +
ridx/hidx): the read×haplotype cross-product ships each unique read/hap
once and the device gather (pack/expand.py expand_factored) rebuilds the
job tiles bit-exactly. Covers the expansion identity, engine/sharded
score invariance, tile padding, and the non-ACGTN (bitmask off) path."""

import numpy as np
import pytest

from genomax.config import EngineConfig
from genomax.engine.executor import Engine
from genomax.io.generator import generate_pairhmm_batch
from genomax.pack.bucketing import pack_pairhmm_batches, pad_tiles_to


def _weird(seed):
    """Batch with an 'X' byte: bitmask translation declines (exact
    byte-equality semantics), factored must carry raw bytes."""
    b = generate_pairhmm_batch(3, 2, read_len=14, hap_len=18, seed=seed)
    b.reads[0].bases = b"AX" + b.reads[0].bases[2:]
    b.haplotypes[0] = b"XA" + b.haplotypes[0][2:]
    return b


def test_expand_factored_matches_unfactored_tiles():
    """Gather + transpose on the unique rows reproduces the byte-qual
    pack's job tiles (codes AND all six qual tables) bit-exactly —
    including the bitmask translation, which commutes with the gather."""
    from genomax.pack.expand import (expand_byte_quals,
                                               expand_factored)

    for batch in (generate_pairhmm_batch(5, 3, read_len=21, hap_len=33,
                                         seed=3),
                  _weird(4)):
        ref_bks, _ = pack_pairhmm_batches([batch], byte_quals=True,
                                          bitmask_codes=True)
        fac_bks, _ = pack_pairhmm_batches([batch], factored=True,
                                          bitmask_codes=True)
        assert len(ref_bks) == len(fac_bks)
        for rb, fb in zip(ref_bks, fac_bks):
            assert rb.bitmask_codes == fb.bitmask_codes
            assert fb.rchar is None and fb.qb is None and fb.hap is None
            got = expand_factored(fb.rchar_u, fb.qb_u, fb.hap_u,
                                  fb.ridx, fb.hidx)
            want = (rb.rchar,) + tuple(
                np.asarray(q) for q in expand_byte_quals(rb.qb)
            ) + (rb.hap,)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), w)
            np.testing.assert_array_equal(rb.meta, fb.meta)
            np.testing.assert_array_equal(rb.ndiag_tile, fb.ndiag_tile)
            np.testing.assert_array_equal(rb.perm, fb.perm)


def test_factored_dedup_actually_dedups():
    """8 haps per read: the unique-read table holds each read ONCE
    (nru = n_reads), an ~8x transfer cut at the bench workload shape."""
    batch = generate_pairhmm_batch(6, 8, read_len=15, hap_len=19, seed=9)
    bks, n = pack_pairhmm_batches([batch], factored=True,
                                          bitmask_codes=True)
    assert n == 48
    assert sum(b.rchar_u.shape[0] - 1 for b in bks) == 6
    assert sum(b.hap_u.shape[0] - 1 for b in bks) == 8 * len(bks)


@pytest.mark.parametrize("batch_seed", [5, None])
def test_engine_pairhmm_invariant_under_factored_transfer(batch_seed,
                                                         cuda_twin):
    """The cuda engine path (kernels replaced by their CPU twins) with
    factored_transfer on == off, exact,
    for both the bitmask (ACGTN) and byte-equality (weird) alphabets."""
    batch = (_weird(6) if batch_seed is None else
             generate_pairhmm_batch(5, 3, read_len=23, hap_len=31,
                                    seed=batch_seed))
    on = Engine(
        EngineConfig(backend="cuda", factored_transfer=True),
    ).pairhmm([batch])
    off = Engine(
        EngineConfig(backend="cuda", factored_transfer=False),
    ).pairhmm([batch])
    np.testing.assert_array_equal(on, off)


def test_sharded_engine_invariant_under_factored_transfer(cuda_twin):
    """Mesh path: replicated unique tables + tile-sharded gather indices
    must score identically to the unfactored sharded dispatch, and the
    sharded stats must still count real cells."""
    from genomax.dist.engine import ShardedEngine
    from genomax.dist.mesh import make_mesh

    mesh = make_mesh(2)
    batch = generate_pairhmm_batch(4, 3, read_len=19, hap_len=27, seed=8)
    res = {}
    for flag in (True, False):
        eng = ShardedEngine(
            mesh,
            EngineConfig(backend="cuda", factored_transfer=flag),
        )
        res[flag] = eng.pairhmm([batch])
        assert eng.last_stats.dp_cells > 0
    np.testing.assert_array_equal(res[True], res[False])


def test_pad_tiles_to_factored_pads_stay_all_pad():
    """Tile padding on a factored pack must route pad lanes to the
    all-pad unique rows, keeping the mask-free pad-decay contract."""
    from genomax.pack.expand import expand_factored
    from genomax.pack.bucketing import PAD_STREAM, PAD_X

    batch = generate_pairhmm_batch(3, 2, read_len=13, hap_len=17, seed=12)
    (b,), _ = pack_pairhmm_batches([batch], factored=True,
                                          bitmask_codes=True)
    nt = b.ridx.shape[0]
    pb = pad_tiles_to(b, nt + 3)
    assert pb.ridx.shape[0] == nt + 3
    assert (pb.ridx[nt:] == b.rchar_u.shape[0] - 1).all()
    assert (pb.hidx[nt:] == b.hap_u.shape[0] - 1).all()
    # unique tables untouched; expanded pad tiles carry only pad codes
    assert pb.rchar_u.shape == b.rchar_u.shape
    rchar, *_quals, hap = expand_factored(pb.rchar_u, pb.qb_u, pb.hap_u,
                                          pb.ridx, pb.hidx)
    pad_x = 0 if b.bitmask_codes else PAD_X  # bitmask LUT maps pads to 0
    assert (np.asarray(rchar)[nt:] == pad_x).all()
    assert (np.asarray(hap)[nt:] == PAD_STREAM).all()
