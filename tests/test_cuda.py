"""The Hopper kernels' arithmetic and schedule on the CPU: the host build
of kernels/csrc/gx_cells.h, run over packed tiles exactly as the kernels
walk them (gx_cells_host.cc), against the full-matrix oracle — plus the
wrapper's shapes, the launch-shape choice and the backend choice. Tests
marked ``gpu`` run the compiled kernels on the card."""

import numpy as np
import pytest

from genomax.config import EngineConfig, PairHMMConfig, SWConfig
from genomax.io.formats import PairHMMRead, SWPair
from genomax.io.generator import generate_pairhmm_batch
from genomax.kernels import cuda, oracle
from genomax.pack.bucketing import (pack_pairhmm_batches, pack_sw_pairs,
                                    unpack_scores)

_ABC = np.frombuffer(b"ATGC", np.uint8)

SW_CFGS = [
    SWConfig(),
    SWConfig(match=2, mismatch=-3, gap_open=0, gap_extend=-1),
    SWConfig(match=5, mismatch=-4, gap_open=-10, gap_extend=-1),
    SWConfig(match=1, mismatch=-2, gap_open=-1, gap_extend=-3),
]


def _sw_pairs(seed, lo, hi, n=24):
    rng = np.random.default_rng(seed)
    pairs = [SWPair(sx=b"", sy=b""), SWPair(sx=b"A", sy=b"A"),
             SWPair(sx=b"A", sy=b"T"), SWPair(sx=b"", sy=b"ACGT"),
             SWPair(sx=b"GATTACA\n", sy=b"")]
    for _ in range(n):
        a = rng.choice(_ABC, int(rng.integers(lo, hi))).tobytes()
        b = rng.choice(_ABC, int(rng.integers(lo, hi))).tobytes()
        if rng.random() < 0.5:  # the reference's trailing-'\n' quirk
            a, b = a + b"\n", b + b"\n"
        pairs.append(SWPair(sx=a, sy=b))
    x = rng.choice(_ABC, min(hi, 60)).tobytes()  # tandem repeat in y
    pairs.append(SWPair(sx=x, sy=x + rng.choice(_ABC, 30).tobytes() + x))
    return pairs


def _host_sw(pairs, cfg=SWConfig(), launch=None):
    buckets = pack_sw_pairs(pairs)
    res = [cuda.host_sw_tiles(b.sx, b.sy, b.nx, b.ny, cfg=cfg,
                              launch=launch or cuda.sw_launch(b))
           for b in buckets]
    return unpack_scores(buckets, res, len(pairs), np.int32)


def _host_phmm(batch, cfg=PairHMMConfig(), bitmask=True, launch=None):
    buckets, n = pack_pairhmm_batches([batch], cfg.phred_offset,
                                      bitmask_codes=bitmask)
    res = [cuda.host_pairhmm_tiles(
        b.rchar, b.qr, b.mmv, b.gapm, b.qi, b.qd, b.qg, b.hap, b.rl, b.hl,
        launch=launch or cuda.pairhmm_launch(b), mm_div=cfg.mm_div,
        bitmask=b.bitmask_codes) for b in buckets]
    return unpack_scores(buckets, res, n, np.float32)


@pytest.mark.parametrize("cfg", SW_CFGS, ids=lambda c: "%d,%d,%d,%d" % (
    c.match, c.mismatch, c.gap_open, c.gap_extend))
@pytest.mark.parametrize("seed,lo,hi", [(1, 1, 12), (2, 10, 70),
                                        (3, 90, 200)])
def test_host_sw_matches_oracle(seed, lo, hi, cfg):
    pairs = _sw_pairs(seed, lo, hi)
    np.testing.assert_array_equal(_host_sw(pairs, cfg),
                                  oracle.sw_scores_pairs(pairs, cfg))


@pytest.mark.parametrize("launch", [(4, 17), (8, 8), (16, 4), (32, 4),
                                    (4, 32), (32, 33)])
def test_host_sw_every_launch_shape(launch):
    """Any (group, cols) covering the bucket gives the oracle's scores,
    including shapes whose last lanes own only columns past the pair."""
    pairs = [p for p in _sw_pairs(7, 1, 66) if len(p.sx) <= 66]
    np.testing.assert_array_equal(_host_sw(pairs, launch=launch),
                                  oracle.sw_scores_pairs(pairs))


def _phmm_batch(seed, read_len=33, hap_len=47):
    b = generate_pairhmm_batch(4, 3, read_len=read_len, hap_len=hap_len,
                               seed=seed)
    b.reads[1].bases = b"N" * 4 + b.reads[1].bases[4:]  # read 'N' rows
    b.haplotypes[2] = b"NN" + b.haplotypes[2][2:]  # hap 'N' columns
    q = bytes([33 + 30] * 5)
    b.reads.append(PairHMMRead(bases=b"ACGTA", base_q=q, ins_q=q, del_q=q,
                               gcp_q=q))  # a read shorter than a lane
    return b


@pytest.mark.parametrize("gatk", [False, True])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_host_pairhmm_matches_oracle(seed, gatk):
    cfg = PairHMMConfig(gatk_emission=gatk)
    batch = _phmm_batch(seed)
    want = oracle.pairhmm_batch_log10(batch, cfg)
    np.testing.assert_allclose(_host_phmm(batch, cfg), want, atol=2e-5)


@pytest.mark.parametrize("bitmask", [True, False])
def test_host_pairhmm_byte_codes(bitmask):
    """Raw byte codes (an alphabet the bitmask cannot hold) keep exact
    byte-equality plus the 'N' wildcard."""
    batch = _phmm_batch(8)
    batch.reads[0].bases = b"AX" + batch.reads[0].bases[2:]
    if bitmask:
        batch.reads[0].bases = b"AC" + batch.reads[0].bases[2:]
    want = oracle.pairhmm_batch_log10(batch)
    np.testing.assert_allclose(_host_phmm(batch, bitmask=bitmask), want,
                               atol=2e-5)


@pytest.mark.parametrize("launch", [(4, 12), (8, 6), (16, 4), (32, 16)])
def test_host_pairhmm_every_launch_shape(launch):
    batch = _phmm_batch(9, read_len=40, hap_len=30)
    np.testing.assert_allclose(_host_phmm(batch, launch=launch),
                               oracle.pairhmm_batch_log10(batch), atol=2e-5)


def test_host_pairhmm_deep_results_leave_the_fp32_range():
    """Without rescaling, fp32 from the 2**120 start stays accurate well
    below the engine's -45 fallback threshold, and a deeper result
    underflows to -inf (non-finite: the engine recomputes it in fp64)."""
    got, want = [], []
    for L in (20, 40, 60, 100):
        b = generate_pairhmm_batch(1, 1, read_len=L, hap_len=L + 10, seed=21)
        b.reads[0].bases = b"A" * L
        b.haplotypes[0] = b"C" * (L + 10)
        got.append(_host_phmm(b)[0])
        want.append(oracle.pairhmm_batch_log10(b)[0])
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-4)
    assert want[1] < -45 and want[3] < -100
    assert got[3] == -np.inf


def test_host_rejects_uninstantiated_cols():
    (b,) = pack_sw_pairs([SWPair(sx=b"ACGT", sy=b"ACGT")])
    with pytest.raises(ValueError, match="not instantiated"):
        cuda.host_sw_tiles(b.sx, b.sy, b.nx, b.ny, launch=(4, 5))


@pytest.mark.parametrize("n_cells,n_steps,cols,want", [
    (513, 513, cuda.SW_COLS, (16, 33)),  # 512bp + '\n': 3% spare columns
    (1025, 1025, cuda.SW_COLS, (32, 33)),  # 1024bp + '\n'

    (65, 65, cuda.SW_COLS, (4, 17)),
    (151, 300, cuda.PHMM_COLS, (16, 10)),
    (1, 1, cuda.SW_COLS, (4, 4)),
])
def test_choose_launch_covers_with_least_work(n_cells, n_steps, cols, want):
    g, c = cuda.choose_launch(n_cells, n_steps, cols)
    assert (g, c) == want
    assert g * c >= n_cells and g in cuda.GROUPS and c in cols


@pytest.mark.parametrize("macro,cols", [("GX_SW_COLS", cuda.SW_COLS),
                                        ("GX_PHMM_COLS", cuda.PHMM_COLS)])
def test_python_cols_match_the_header(macro, cols):
    """The launch choice may only pick widths the kernels instantiate."""
    import os
    import re

    with open(os.path.join(os.path.dirname(cuda.__file__), "csrc",
                           "gx_cells.h")) as f:
        line = re.search(rf"#define {macro}\(X\)(.*)", f.read()).group(1)
    assert tuple(int(c) for c in re.findall(r"X\((\d+)\)", line)) == cols


def test_choose_launch_raises_past_the_kernel_reach():
    assert cuda.SW_MAX_X == 1056 and cuda.PHMM_MAX_READ == 512
    with pytest.raises(ValueError, match="reach"):
        cuda.choose_launch(cuda.SW_MAX_X + 1, 10, cuda.SW_COLS)


def test_wrapper_shapes_via_eval_shape():
    import jax
    import jax.numpy as jnp

    S = jax.ShapeDtypeStruct
    nt = 3
    sw = jax.eval_shape(
        lambda *a: cuda.sw_tiles(*a, cfg=SWConfig(), launch=(8, 9)),
        S((nt, 72, 128), jnp.int8), S((nt, 512, 128), jnp.int8),
        S((nt * 128,), jnp.int32), S((nt * 128,), jnp.int32))
    assert sw.shape == (nt, 128) and sw.dtype == jnp.int32
    f = S((nt, 160, 128), jnp.float32)
    ph = jax.eval_shape(
        lambda *a: cuda.pairhmm_tiles(*a, launch=(16, 10), bitmask=True),
        S((nt, 160, 128), jnp.int8), f, f, f, f, f, f,
        S((nt, 768, 128), jnp.int8), S((nt * 128,), jnp.int32),
        S((nt * 128,), jnp.int32))
    assert ph.shape == (nt, 128) and ph.dtype == jnp.float32


def test_backend_auto_resolves_to_lax_without_gpu():
    assert EngineConfig().resolve_backend() == "lax"
    assert EngineConfig(backend="lax").resolve_backend() == "lax"


def test_backend_cuda_without_gpu_raises_clearly():
    from genomax.engine.executor import Engine

    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        Engine(EngineConfig(backend="cuda"))


def test_backend_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        EngineConfig(backend="pallas").resolve_backend()


def test_backend_auto_resolves_to_cuda_on_gpu(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert EngineConfig().resolve_backend() == "cuda"


# -- on the card ------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_sw_kernel_matches_lax(gpu):
    """Every launch shape (x up to the kernel's 1,056-byte reach), four
    scoring configs, and a 16-symbol alphabet, bit-exact vs lax."""
    from genomax.engine.executor import Engine

    rng = np.random.default_rng(12)
    pairs = _sw_pairs(11, 1, 300, n=300)
    for lo, hi in ((300, 700), (700, 1057)):
        pairs += [SWPair(sx=rng.choice(_ABC, int(rng.integers(lo, hi))).tobytes(),
                         sy=rng.choice(_ABC, int(rng.integers(lo, hi))).tobytes())
                  for _ in range(40)]
    wide = np.frombuffer(b"ABCDEFGHIJKLMNOP", np.uint8)
    pairs += [SWPair(sx=rng.choice(wide, 90).tobytes(),
                     sy=rng.choice(wide, 120).tobytes()) for _ in range(20)]
    for cfg in SW_CFGS:
        got = Engine(EngineConfig(backend="cuda"), sw_cfg=cfg).sw_scores(pairs)
        want = Engine(EngineConfig(backend="lax"), sw_cfg=cfg).sw_scores(pairs)
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("gatk", [False, True])
@pytest.mark.parametrize("alphabet", ["bitmask", "bytes"])
def test_gpu_pairhmm_kernel_matches_lax(gpu, gatk, alphabet):
    """Both emission models and both code forms (one-hot bitmask codes,
    raw bytes for an alphabet beyond ACGTN), vs lax and the fp64 model."""
    from genomax import native
    from genomax.engine.executor import Engine

    cfg = PairHMMConfig(gatk_emission=gatk)
    batch = generate_pairhmm_batch(64, 4, read_len=151, hap_len=300, seed=1,
                                   from_haps=True)
    batch.reads.append(_phmm_batch(2).reads[1])  # 'N' rows
    if alphabet == "bytes":
        batch.reads[0].bases = b"AX" + batch.reads[0].bases[2:]
    got = Engine(EngineConfig(backend="cuda"), phmm_cfg=cfg).pairhmm([batch])
    want = Engine(EngineConfig(backend="lax"), phmm_cfg=cfg).pairhmm([batch])
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(
        got, native.pairhmm_native([batch], gatk_emission=gatk), atol=1e-4)
