"""Full-matrix numpy golden models (the differential-test oracle).

These are deliberately simple, unvectorized-in-the-hot-axis implementations
of the exact reference semantics, used to validate the device kernels on small
random inputs — the automated version of the reference's own
matrix-vs-antidiagonal differential testing (README.md:2; SURVEY.md §4).

Semantics sources:
  SW     — antidiagonalSmithWaterman.c:82-92 (saturating -inf algebra),
           :290-306 (boundary rows), :309-335 (P/Q/D recurrence + max).
  PairHMM— pairHMMmatrix.c:32-38 (emission/transition), :41-56 (forward),
           :43-46 (Y0 init DBL_MAX/16/hap_len), :59-66 (likelihood).
"""

from __future__ import annotations

import numpy as np

from genomax.config import NEG_INF_I32, PairHMMConfig, SWConfig
from genomax.io.phred import phred_to_error_prob

_DBL_MAX_16 = np.finfo(np.float64).max / 16.0


def _sat_add(a: int, b: int) -> int:
    """sum_with_infinity: -inf absorbing, never wraps
    (antidiagonalSmithWaterman.c:86-88)."""
    if a == NEG_INF_I32 or b == NEG_INF_I32:
        return NEG_INF_I32
    return a + b


def sw_score(sx: bytes, sy: bytes, cfg: SWConfig = SWConfig()) -> int:
    """Affine-gap local alignment score of one pair (sx = columns)."""
    nx, ny = len(sx) + 1, len(sy) + 1
    P = np.zeros((ny, nx), dtype=np.int64)
    Q = np.zeros((ny, nx), dtype=np.int64)
    D = np.zeros((ny, nx), dtype=np.int64)
    # first row: P=-inf, Q=0, D=0; first col: P=0, Q=-inf, D=0
    P[0, :] = NEG_INF_I32
    Q[:, 0] = NEG_INF_I32
    P[:, 0] = 0
    Q[0, :] = 0
    # reference order: the (0,0) cell takes the row-boundary values
    P[0, 0] = NEG_INF_I32
    Q[0, 0] = 0
    og_e = cfg.gap_open + cfg.gap_extend
    best = 0
    for i in range(1, ny):
        for j in range(1, nx):
            P[i, j] = max(_sat_add(D[i - 1, j], og_e), _sat_add(P[i - 1, j], cfg.gap_extend))
            Q[i, j] = max(_sat_add(D[i, j - 1], og_e), _sat_add(Q[i, j - 1], cfg.gap_extend))
            sub = cfg.match if sy[i - 1] == sx[j - 1] else cfg.mismatch
            D[i, j] = max(P[i, j], Q[i, j], D[i - 1, j - 1] + sub, 0)
            if D[i, j] > best:
                best = int(D[i, j])
    return best


def sw_scores_pairs(pairs, cfg: SWConfig = SWConfig()) -> np.ndarray:
    return np.array([sw_score(p.sx, p.sy, cfg) for p in pairs], dtype=np.int32)


def pairhmm_log10(
    read_bases: bytes,
    base_q: bytes,
    ins_q: bytes,
    del_q: bytes,
    gcp_q: bytes,
    hap: bytes,
    cfg: PairHMMConfig = PairHMMConfig(),
) -> float:
    """log10 likelihood of one read×haplotype pair, fp64 full matrix.

    Matches pairHMMmatrix.c exactly, including the plain-Qr mismatch
    emission (no GATK Qr/3) and the DBL_MAX/16 scaling.
    """
    rl, hl = len(read_bases), len(hap)
    qr = phred_to_error_prob(np.frombuffer(base_q, np.uint8), cfg.phred_offset)
    qi = phred_to_error_prob(np.frombuffer(ins_q, np.uint8), cfg.phred_offset)
    qd = phred_to_error_prob(np.frombuffer(del_q, np.uint8), cfg.phred_offset)
    qg = phred_to_error_prob(np.frombuffer(gcp_q, np.uint8), cfg.phred_offset)

    r = np.frombuffer(read_bases, np.uint8)
    h = np.frombuffer(hap, np.uint8)
    N = ord("N")
    mmdiv = 3.0 if cfg.gatk_emission else 1.0

    M = np.zeros((rl + 1, hl + 1), dtype=np.float64)
    X = np.zeros((rl + 1, hl + 1), dtype=np.float64)
    Y = np.zeros((rl + 1, hl + 1), dtype=np.float64)
    Y[0, :] = _DBL_MAX_16 / float(hl)

    for i in range(1, rl + 1):
        mmv = 1.0 - (qi[i - 1] + qd[i - 1])
        gapm = 1.0 - qg[i - 1]
        for j in range(1, hl + 1):
            match = r[i - 1] == h[j - 1] or r[i - 1] == N or h[j - 1] == N
            p = (1.0 - qr[i - 1]) if match else qr[i - 1] / mmdiv
            M[i, j] = p * (mmv * M[i - 1, j - 1] + gapm * (X[i - 1, j - 1] + Y[i - 1, j - 1]))
            X[i, j] = M[i - 1, j] * qi[i - 1] + X[i - 1, j] * qg[i - 1]
            Y[i, j] = M[i, j - 1] * qd[i - 1] + Y[i, j - 1] * qg[i - 1]

    # likelihood(): sum over last row j = 1..hl in order (pairHMMmatrix.c:59-66)
    l = 0.0
    for j in range(1, hl + 1):
        l += M[rl, j] + X[rl, j]
    return float(np.log10(l) - np.log10(_DBL_MAX_16))


def pairhmm_batch_log10(batch, cfg: PairHMMConfig = PairHMMConfig()) -> np.ndarray:
    """Read-major (read outer, haplotype inner) per-pair log10 likelihoods,
    matching the reference output order (pairHMMmatrix.c:207-258)."""
    out = []
    for rd in batch.reads:
        for hp in batch.haplotypes:
            out.append(
                pairhmm_log10(rd.bases, rd.base_q, rd.ins_q, rd.del_q, rd.gcp_q, hp, cfg)
            )
    return np.array(out, dtype=np.float64)
