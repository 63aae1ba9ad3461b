"""Anti-diagonal wavefront step math: the pure-JAX (lax) twins of the
device kernels, and the reference path of the engine.

Formulation (NOT how the reference lays it out — the reference strides
one CUDA thread window along each diagonal with __syncthreads barriers,
smithWaterman.cu:283-344 / pairHMM.cu:274-343):

  * **Position-major layout**: one anti-diagonal of one DP matrix lives
    along axis 0 (position p of the x/read sequence = row p); a tile of
    128 independent pairs lives along axis 1. All state is (NXs, L)
    arrays — the rotating 3-diagonal window of the reference
    (antidiagonalSmithWaterman.c:96-184) becomes loop carries.
  * Neighbor access along the diagonal is a roll by one row. Shifted
    copies of the previous diagonal are carried forward so each step
    rolls only the values it just produced (2 rolls/step for SW, 3 for
    PairHMM).
  * The streamed second sequence enters as a *reversed diagonal stream*
    buffer anchored at A = NDs - NXs (sy[k] at row A-1-k): the window
    needed at diagonal d is rows [A-d, A-d+NXs) — a dynamic-offset slice
    along axis 0 (no gather). See stream_window below and
    genomax/layout.py for the bound proofs.
  * The running result (SW max / PairHMM last-row likelihood sum) is
    accumulated into a per-row *vector*; the cross-row reduction happens
    once at the end.
  * Loop-invariant masks/constants are hoisted into a per-sweep "consts"
    bundle computed once.

SW int semantics: the reference's -infinity is INT_MIN with a saturating
add (antidiagonalSmithWaterman.c:38,86-88). Here the boundary conditions
are not even materialized: the packing's pad codes (x pads with 1, the
stream with 0 — never equal to each other or to any real base / '\\n';
0 also makes the big stream buffers calloc-free to allocate)
guarantee every out-of-matrix cell mismatches, so D decays to 0, P/Q
decay to small negatives, and the recurrences applied uniformly over the
full (NXs, 128) tile — boundaries, pads, ragged lanes and all — produce
exactly the reference's scores. This removes ~8 ops from a ~13-op inner
loop. Differential tests vs the full-matrix oracle cover all of these.

Row wrap-around needs one extra ingredient. The roll is CIRCULAR, so without countermeasures the bottom row's D/Q wrap into
row 0 and decay only a few mismatch penalties per diagonal — a pair
whose y contains a second x-similar region ~NXs columns later (tandem
repeats, short-read vs long-reference) would silently inflate. Rather
than select-zeroing every rolled carry (2 extra ops per step), the
boundary rows are PINNED through the constant vectors that already ride
the recurrence, at zero per-step cost:

  * packing guarantees the bottom row NXs-1 is a pad row for every
    lane (pack rounds nx_max+2 up to the row quantum);
  * ``ogev`` (the hoisted gap-open+extend added to max(P,Q) inside D)
    carries -KILL at the bottom row, and ``subm``/``subx`` carry -KILL
    there too, so D[NXs-1] = max(S-KILL, max(S'-KILL, 0)) = 0 exactly —
    the roll then wraps a clean 0 into row 0 of the next D1s/D2s, which
    IS the reference's first-column D boundary;
  * ``gev`` (the gap-extend added to Q's carried copy) carries -KILL at
    row 0, killing the wrapped Q: Q[0] = max(D1s[0]=0, S-KILL) = 0.

By induction rows 0 and NXs-1 then hold exactly (D=0, Q'=0, P'<=0) —
the reference's first-column boundary (:290-306) — every step, so the
interior pad-decay proof applies as if the buffer were unbounded. KILL
= 2**28 dominates any real score chain (scores are bounded by sequence
length << 2**26) while keeping every int32 add far from wrapping, and
the killed values never enter a carry (each is floored away by the same
max that consumes it).

PairHMM numerics: the device paths run fp32. The reference keeps
magnitudes afloat with a DBL_MAX/16 initial constant in fp64
(pairHMMmatrix.c:43-46). Here the initial constant is 2**120 in fp32 and a per-pair exponent shift is
tracked: when the in-window diagonal max (across BOTH live diagonals —
the older one bounds the overflow headroom) decays below 2**40, all
value carries are multiplied by 2**80 and the final log10 result is
shifted back. The likelihood accumulator carries its own exponent (see
phmm_step). This supports >70 decimal orders of within-diagonal dynamic
range and unbounded total range; the engine routes anything deeper to
the native fp64 golden model (GKL-style fallback). PairHMM's boundary
analysis mirrors SW's: M/X decay to exact zeros outside the matrix
(pad positions carry qr=qi=qg=0 and guaranteed-mismatch codes), the
row-0 Y = 2**120/hap_len constant persists from its state init through
a qg[0]=1 const (PhmmConsts docstring), and the accumulator mask
bounds j <= hap_len.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp

from genomax.config import SWConfig

# PairHMM fp32 scaling scheme.
PHMM_INIT_LOG2 = 120  # initial constant = 2**120
PHMM_RESCALE_TRIGGER = 2.0**40
PHMM_RESCALE_FACTOR = 2.0**80
PHMM_RESCALE_LOG10 = 80 * 0.30102999566398120  # log10(2**80)
PHMM_INIT_LOG10 = 120 * 0.30102999566398120
_N_CODE = ord("N")

# Layout constants shared with the packers — single source of truth in
# genomax/layout.py (re-exported here for the existing kernel imports).
from genomax.layout import (LANES, PAD_STREAM, PAD_X,  # noqa: F401
                            STREAM_CHUNK)

# Boundary-row kill constant (module docstring): dominates any real score
# chain yet keeps int32 adds far from wrapping.
KILL = 1 << 28


def stream_window(buf, d, nxs):
    """Rows [A-d, A-d+nxs) of the reversed stream buffer, A = NDs-nxs:
    sublane s of the window holds stream[d-1-s] — the code that cell
    (x=s, y=d-s) compares against (buf[k] = stream[A-1-k], codes packed
    at [A-len, A)). Pure dynamic-offset load, in bounds for every
    d < A (packing sets A >= n_diags + MAX_UNROLL, covering the sweep's
    round-up overshoot).

    The CUDA kernels read the same stream element by element
    (kernels/csrc/gx_cells.h stream_code)."""
    nds = buf.shape[0]
    return jax.lax.dynamic_slice_in_dim(buf, nds - nxs - d, nxs, axis=0)


def wavefront_sweep(nd, state, step_fn, unroll: int, block_fn=None):
    """Run the wavefront: ceil(nd/unroll) outer iterations, each tracing
    ``unroll`` python-unrolled steps (static inner trip count → no
    per-diagonal loop overhead). ``block_fn``
    (the PairHMM rescale) runs once per block, keeping its cross-sublane
    reduction out of the hot path entirely.

    May run up to unroll-1 diagonals past ``nd``; that is harmless by the
    pad-decay invariants (cells past a pair's last diagonal never pass
    the result masks, and pad cells never feed valid cells)."""

    def outer(c, st):
        base = c * unroll
        for t in range(unroll):
            st = step_fn(base + t, st)
        if block_fn is not None:
            st = block_fn(st, base + unroll - 1)
        return st

    n_blocks = (nd + unroll - 1) // unroll
    return jax.lax.fori_loop(0, n_blocks, outer, state)


# ---------------------------------------------------------------------------
# Smith-Waterman
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SWConsts:
    """Loop-invariant values, computed once per sweep.

    subm/subx/gev/ogev are full (NXs, L) vectors whose boundary rows
    carry the -KILL pins that neutralize the circular roll's
    wrap-around (module docstring)."""

    sxb: Any  # (NXs, L) position-fixed codes (row p = sx[p-1])
    subm: Any  # (NXs, L) match-score vector, -KILL at the bottom row
    subx: Any  # (NXs, L) mismatch vector, -KILL at the bottom row
    gev: Any  # (NXs, L) gap_extend for Q's carry, -KILL at row 0
    ogev: Any  # (NXs, L) gap_open+gap_extend for D, -KILL at bottom row
    window: Callable  # d -> (NXs, L) stream window (see stream_window)
    roll1: Callable
    cfg: SWConfig


def sw_make_consts(sxb, window, roll1, cfg: SWConfig) -> SWConsts:
    zero = sxb - sxb
    ii = jax.lax.broadcasted_iota(jnp.int32, sxb.shape, 0)
    row0 = ii == 0
    rowl = ii == sxb.shape[0] - 1
    return SWConsts(
        sxb=sxb,
        subm=jnp.where(rowl, -KILL, zero + cfg.match),
        subx=jnp.where(rowl, -KILL, zero + cfg.mismatch),
        gev=jnp.where(row0, -KILL, zero + cfg.gap_extend),
        ogev=jnp.where(rowl, -KILL, zero + cfg.gap_open + cfg.gap_extend),
        window=window, roll1=roll1, cfg=cfg,
    )


def sw_make_state(z):
    """Initial (P1, D1, D1s, Q1s, D2s, mx) carries; all zero. ``z``: a
    (NXs, L) zero template of the DP dtype."""
    return (z, z, z, z, z, z)


def sw_block(base, state, c: SWConsts, unroll: int):
    """``unroll`` python-unrolled steps, each computing anti-diagonal d of
    P/Q/D from diagonals d-1 and d-2 (recurrences at
    antidiagonalSmithWaterman.c:309-335; boundaries :290-306 arise from
    pad-code decay plus the -KILL boundary-row pins riding gev/ogev/sub,
    see module docstring; the gap-open+extend add is hoisted into D's max
    since P/Q are carried in open-relative form: P' = P - (open+extend)).
    The running-max update is folded to every other step (max is
    associative). Pairing stays inside the block, so any even or odd
    unroll is handled."""
    P1, D1, D1s, Q1s, D2s, mx = state
    cfg = c.cfg
    prevD = None
    for t in range(unroll):
        syw = c.window(base + t)
        Pn = jnp.maximum(D1, P1 + cfg.gap_extend)
        Qn = jnp.maximum(D1s, Q1s + c.gev)
        sub = jnp.where(syw == c.sxb, c.subm, c.subx)
        Dn = jnp.maximum(
            jnp.maximum(Pn, Qn) + c.ogev, jnp.maximum(D2s + sub, 0)
        )
        if t % 2 == 1:
            mx = jnp.maximum(mx, jnp.maximum(prevD, Dn))
        elif t == unroll - 1:
            mx = jnp.maximum(mx, Dn)
        prevD = Dn
        P1, D1, D1s, Q1s, D2s = Pn, Dn, c.roll1(Dn), c.roll1(Qn), D1s
    return (P1, D1, D1s, Q1s, D2s, mx)


def sw_forward_dense(
    sx, sy_rev, nx, ny, n_diags, cfg: SWConfig = SWConfig(), unroll: int = 8
):
    """Pure-JAX batched SW over densely packed pairs (the 'lax' backend
    and the differential twin of the CUDA kernel).

    sx: (NXs, L) int32 position-fixed codes; sy_rev: (NDs, L) reversed
    diagonal stream; nx, ny: (L,) int32 true dims (len+1, unused — kept
    for API parity with bucketing metadata); n_diags: loop bound.
    Returns (L,) int32 scores.
    """
    del nx, ny  # lengths are encoded via pad codes; see module docstring
    # Widen up front: the packs ship int8 code tiles, and the DP state /
    # -KILL boundary consts below inherit the input dtype — int8 would
    # wrap KILL=2**28 to 0 (losing the wrap-around pins) and overflow
    # scores at 127.
    sx = sx.astype(jnp.int32)
    sy_rev = sy_rev.astype(jnp.int32)
    roll1 = functools.partial(jnp.roll, shift=1, axis=0)
    window = functools.partial(stream_window, sy_rev, nxs=sx.shape[0])
    c = sw_make_consts(sx, window, roll1, cfg)

    def outer(i, st):
        return sw_block(i * unroll, st, c, unroll)

    z = jnp.zeros(sx.shape, sx.dtype)
    n_blocks = (n_diags + unroll - 1) // unroll
    state = jax.lax.fori_loop(0, n_blocks, outer, sw_make_state(z))
    return jnp.max(state[5].astype(jnp.int32), axis=0)


# ---------------------------------------------------------------------------
# PairHMM forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhmmConsts:
    """Loop-invariant values, computed once per sweep.

    Three emission/boundary folds keep the hot step at ~20 ops:
      * read-'N' wildcard folded into qr (qr := pm at 'N' rows, so
        both select branches agree and the per-step `| rn` disappears);
      * qg := 1 at row 0, so the row-0 Y boundary constant PERSISTS
        from its state init (Yn[0] = Y1[0]*1) instead of being re-added
        every step (y0row holds the init values; the rescale can
        multiply row-0 Y only after rows 0/1 leave the live window, at
        which point only dead j>hap_len cells consume it — same
        containment argument as before);
      * the accumulator takes raw (Mn+Xn) contributions into a per-
        block partial (cmul is constant within a block; phmm_rescale
        folds partial*cmul once per block)."""

    rchar: Any  # (NXs, L) sublane-fixed read codes (sublane i = R[i-1])
    pm: Any  # (NXs, L) 1 - Qr  (match emission), 0 at row 0 / pad rows
    qr: Any  # (NXs, L) Qr, with the 'N'-read and dead-row folds
    mmv: Any  # (NXs, L) 1 - (Qi + Qd)
    gapm: Any  # (NXs, L) 1 - Qg
    qi: Any
    qd: Any
    qg: Any  # 1 - at row 0 (Y persistence), packed Qg elsewhere
    row0: Any  # (NXs, L) bool: sublane 0
    rlmask: Any  # (NXs, L) bool: sublane == read_len (the result row)
    y0row: Any  # (NXs, L) f32: 2**120 / hap_len at sublane 0, 0 elsewhere
    rl: Any  # (1, L) int32
    hl: Any  # (1, L) int32
    rlhl: Any  # (1, L) int32: rl + hl (the pair's last live diagonal)
    ii: Any  # (NXs, L) int32 sublane iota
    window: Callable  # d -> (NXs, L) haplotype stream window
    roll1: Callable
    bitmask: bool = False  # codes are one-hot match bitmasks (pack)


def phmm_make_consts(rchar, qr, mmv, gapm, qi, qd, qg, rl, hl, window,
                     roll1, mm_div: float = 1.0,
                     bitmask: bool = False) -> PhmmConsts:
    """mm_div: mismatch-emission divisor — 1.0 reproduces the reference
    (plain Qr), 3.0 is the true GATK/GKL emission (Qr/3); see
    PairHMMConfig.gatk_emission.

    bitmask: rchar/stream carry one-hot match-bitmask codes
    (PairHMMPacked.bitmask_codes) — the emission test in phmm_step
    becomes one and+compare instead of two compares + or.

    (A scaled-recurrence reformulation — X' = X/qi, Y' = Y/qd with
    telescoped coefficients — lived here r4-r5 behind an opt-in flag;
    it measured 5-14% SLOWER on hardware and was deleted per contract.
    Post-mortem: DESIGN.md §3b/§4; full code at git tag r4 8431b4b.)"""
    nxs, L = qr.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, (nxs, L), 0)
    row0 = ii == 0
    y0 = (2.0**PHMM_INIT_LOG2) / jnp.maximum(hl, 1).astype(jnp.float32)
    # pm = 0 at row 0 and pad rows: with qi/qd/qg/mmv/gapm packed as 0
    # there, every M/X/Y product chain is EXACTLY zero outside the live
    # matrix — including values the circular sublane roll wraps from the
    # bottom row into row 0, and 'N'-run haplotypes whose match-all
    # emission would otherwise make pad rows transparent (p = 1-qr = 1).
    dead = row0 | (ii > rl)
    rn = rchar == (15 if bitmask else _N_CODE)
    qgp = jnp.where(row0, 1.0, qg)
    return PhmmConsts(
        rchar=rchar,
        bitmask=bitmask,
        pm=jnp.where(dead, 0.0, 1.0 - qr),
        qr=jnp.where(dead, 0.0, jnp.where(rn, 1.0 - qr, qr * (1.0 / mm_div))),
        mmv=mmv,
        gapm=gapm,
        qi=qi,
        qd=qd,
        qg=qgp,
        row0=row0,
        rlmask=ii == rl,
        y0row=jnp.where(row0, y0, 0.0),
        rl=rl,
        hl=hl,
        rlhl=rl + hl,
        ii=ii,
        window=window,
        roll1=roll1,
    )


def phmm_make_state(z, y0row):
    """(M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s, acc, accb, cmul, acc_log).

    M1/Y1 are the previous diagonal unshifted; *1s are its roll-by-one
    copies; *2s are the roll-by-one copies of the diagonal before it
    (carried forward — each step only rolls what it just computed).
    Y1 initializes to the row-0 boundary constant, which then PERSISTS
    through qg[0]=1 (PhmmConsts docstring). accb is the per-block raw
    contribution partial. z: (NXs, L) f32 zero template (see
    sw_make_state layout note)."""
    zc = z[0:1]
    return (z, z + y0row, z, z, z, z, z, z, z, z, zc + 1.0, zc)


def phmm_step(d, state, c: PhmmConsts):
    """Compute anti-diagonal d of M/X/Y (pairHMMmatrix.c:49-55).

    Sublane axis = read index i; all per-base arrays are sublane-fixed
    (sublane i holds quality index i-1). The stream window invariant:
    sublane i of the window at diagonal d holds H[d-1-i] = H[j-1] for
    the cell (i, j=d-i).

    Boundary handling (module docstring): M/X/Y are exact zeros at all
    out-of-matrix cells by pad-code decay (pads carry qr=qi=qg=0 and
    guaranteed-mismatch codes, so every product chain is zero); only the
    row-0 Y = 2**120/hap_len constant is injected, via one add of the
    precomputed one-row vector y0row (row-0 M,X are naturally zero, and
    Yn's recurrence contributes exact 0 at row 0, so add == select).

    Scaling invariants: the M/X/Y diagonals carry a shared per-pair scale
    (rescale events push it up by 2**80, phmm_rescale); the likelihood
    accumulator ``acc`` carries its OWN scale (``acc_log``, log10) with
    contributions folded in through ``cmul`` = 2**(-80 * (buffer_rescales
    - acc_rescales)). The accumulator follows the buffer scale while it
    is small, then freezes; frozen-scale contributions that underflow
    cmul are provably below fp32 summation noise. The row-0 constant
    never rescales: a rescale can only fire once rows 0/1 have left the
    valid window (row-0 Y is pinned at 2**120/hl >= 2**106, far above
    the 2**40 trigger), and valid cells only consume in-window values.
    """
    M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s, acc, accb, cmul, acc_log = state

    hw = c.window(d)

    # emission p() (pairHMMmatrix.c:32-34); the read-'N' wildcard is
    # folded into the qr const (both branches agree there). With
    # bitmask codes (one-hot ACGT, N=15, pads 0 — pack_pairhmm_batches)
    # the byte-equality + hap-'N'-wildcard test collapses to one
    # and+compare: (bm & oh) != 0.
    if c.bitmask:
        match = (c.rchar & hw) != 0
    else:
        match = (c.rchar == hw) | (hw == _N_CODE)
    p = jnp.where(match, c.pm, c.qr)

    Mn = p * (c.mmv * M2s + c.gapm * (X2s + Y2s))
    Xn = M1s * c.qi + X1s * c.qg
    Yn = M1 * c.qd + Y1 * c.qg  # row-0 const persists via qg[0]=1

    # Last-row likelihood accumulation (antidiagsPairHMM.c:206-212): the
    # cell (read_len, j) lands at sublane rl exactly once per diagonal,
    # in increasing-j order — the reference's summation order. Cells with
    # j > hap_len are masked out via the per-pair last-live-diagonal
    # d <= rl+hl — a 1-row compare broadcast against the rl mask (the
    # only cell rlmask admits at diagonal d is j = d-rl, so j <= hl is
    # exactly d <= rl+hl); j <= 0 contributes exact zeros (col-0 zeros /
    # untouched sublanes), so no lower-bound check is needed. Raw
    # contributions collect in accb; phmm_rescale folds accb*cmul into
    # acc once per block (cmul is constant within a block).
    # r4 op-shave: accumulate at EVERY row still inside the pair's live
    # diagonal span (the 1-row d <= rl+hl gate broadcasts; ~free) and
    # extract the rl row ONCE at finalize through rlmask — the per-step
    # `rlmask &` disappears (-1 of 18 ALU ops). Bit-identical at the
    # result row: its adds and their order are unchanged. Off-rl rows
    # accumulate mid-matrix garbage that may reach +inf after many
    # blocks, and once an off-rl row of acc is inf it stays inf for the
    # rest of the sweep (contrib >= 0, so inf never meets -inf — no NaN
    # is ever produced; phmm_rescale resets accb with literal zeros, not
    # accb-accb, precisely so an inf row cannot turn into NaN there).
    # Correctness therefore rests SOLELY on the rlmask SELECTS in
    # phmm_rescale's asum and phmm_finalize: any new consumer of
    # acc/accb must read them through a select (never a multiply —
    # 0*inf = NaN) or this invariant breaks silently.
    gate = jnp.asarray(d, jnp.int32) <= c.rlhl
    accb = accb + jnp.where(gate, Mn + Xn, 0.0)

    return (
        Mn,
        Yn,
        c.roll1(Mn),
        c.roll1(Xn),
        c.roll1(Yn),
        M1s,
        X1s,
        Y1s,
        acc,
        accb,
        cmul,
        acc_log,
    )


def phmm_rescale(state, d, c: PhmmConsts):
    """Per-pair exponent rescale, applied once per unrolled block.

    The peak is taken over BOTH live diagonals (current values M1/Y1 and
    X1s with a shifted window mask, plus the older *2s copies): the older
    diagonal can exceed the newer one by the per-diagonal decay, and it
    is multiplied by the same factor, so it must bound the overflow
    headroom (trigger 2**40 * factor 2**80 <= 2**120 << FLT_MAX).
    Unconditional in dataflow terms: lanes not rescaling multiply by 1.0.

    The peak is masked to the exactly-live DP window per sublane (the
    boundary-free step leaves decaying-but-nonzero values at cells past
    a pair's haplotype end, which must not distort the peak), and the
    whole rescale is gated on the pair still having live diagonals
    (d <= rl+hl+1), so finished pairs stop rescaling entirely.

    Also folds the block's raw contribution partial into the
    accumulator (acc += accb * cmul, accb reset) BEFORE the follow
    decision, so asum sees the up-to-date value."""
    M1, Y1, M1s, X1s, Y1s, M2s, X2s, Y2s, acc, accb, cmul, acc_log = state
    acc = acc + accb * cmul
    # Literal zeros, NOT accb-accb: off-rl rows of accb can legitimately
    # reach +inf (unmasked mid-matrix mass, see the phmm step op-shave
    # comment) and inf - inf = NaN would poison the row permanently;
    # zeros survive any input (ADVICE r4).
    accb = jnp.zeros_like(accb)
    ii, rl, hl = c.ii, c.rl, c.hl
    jv = d - ii
    # window of the current diagonal d (cells (i, d-i))
    v0 = (ii <= rl) & (jv >= 0) & (jv <= hl)
    # window of shifted copies: sublane i holds cell (i-1, *) of diag d-1
    jv1 = (d - 1) - (ii - 1)
    v1 = (ii >= 1) & (ii - 1 <= rl) & (jv1 >= 0) & (jv1 <= hl)
    # window of shifted copies of diag d-2
    jv2 = (d - 2) - (ii - 1)
    v2 = (ii >= 1) & (ii - 1 <= rl) & (jv2 >= 0) & (jv2 <= hl)

    zero = jnp.zeros_like(M1)
    live = jnp.where(v0, jnp.maximum(M1, Y1), zero)
    live = jnp.maximum(
        live, jnp.where(v1, jnp.maximum(jnp.maximum(M1s, X1s), Y1s), zero)
    )
    live = jnp.maximum(
        live, jnp.where(v2, jnp.maximum(jnp.maximum(M2s, X2s), Y2s), zero)
    )
    peak = jnp.max(live, axis=0, keepdims=True)
    alive = jnp.asarray(d, jnp.int32) <= rl + hl + 1
    need = alive & (peak > 0.0) & (peak < PHMM_RESCALE_TRIGGER)
    f = jnp.where(need, PHMM_RESCALE_FACTOR, 1.0)
    # Depth limit (measured): the single shared scale keeps the WINDOW
    # PEAK afloat, so cells >~50 orders below the running peak flush to
    # zero in the buffers themselves — results below ~-50 log10 lose
    # mass regardless of accumulator scheme (a two-way-normalized
    # floating accumulator was tried and changed nothing). That is why
    # the engine's fp64 fallback threshold (-45) is load-bearing; it
    # mirrors GKL's fp32-with-fp64-fallback production design.
    # The accumulator follows the buffer scale only while small. Only
    # the rl row is the real accumulator (phmm_step's gate admits every
    # live row; finalize extracts rl) — mask before reducing, or
    # off-row garbage would freeze the scale early.
    asum = jnp.max(jnp.where(c.rlmask, acc, 0.0), axis=0, keepdims=True)
    follow = need & (asum < PHMM_RESCALE_TRIGGER)
    return (
        M1 * f,
        Y1 * f,
        M1s * f,
        X1s * f,
        Y1s * f,
        M2s * f,
        X2s * f,
        Y2s * f,
        acc * jnp.where(follow, PHMM_RESCALE_FACTOR, 1.0),
        accb,
        cmul * jnp.where(need & ~follow, 1.0 / PHMM_RESCALE_FACTOR, 1.0),
        acc_log - jnp.where(follow, PHMM_RESCALE_LOG10, 0.0),
    )


def phmm_finalize(state, c: PhmmConsts):
    """log10(sum of last-row M+X) minus the scaling constant
    (pairHMMmatrix.c:59-66), exponent shifts folded back in. accb is
    always freshly-folded here (phmm_rescale runs after every block,
    including the last). The rlmask select extracts the one real
    accumulator row (phmm_step accumulates at every live row; the
    off-row garbage — possibly inf — dies in this select)."""
    acc, acc_log = state[8], state[11]
    total = jnp.sum(jnp.where(c.rlmask, acc, 0.0), axis=0, keepdims=True)
    return (jnp.log10(total) + acc_log - PHMM_INIT_LOG10)[0]


def phmm_forward_dense(
    rchar,
    qr,
    mmv,
    gapm,
    qi,
    qd,
    qg,
    hap_rev,
    rl,
    hl,
    n_diags,
    rescale_period: int = 32,
    mm_div: float = 1.0,
    bitmask: bool = False,
):
    """Pure-JAX batched PairHMM forward (the 'lax' backend).

    rchar: (NXs, L) int codes; the 6 quality arrays: (NXs, L) f32
    sublane-fixed (sublane i = base i-1). hap_rev: (NDs, L) int reversed
    diagonal stream. rl, hl: (L,) true lengths. Returns (L,) f32 log10
    likelihoods relative to the reference constant.
    """
    L = qr.shape[1]
    roll1 = functools.partial(jnp.roll, shift=1, axis=0)
    window = functools.partial(stream_window, hap_rev, nxs=qr.shape[0])
    c = phmm_make_consts(
        rchar, qr, mmv, gapm, qi, qd, qg,
        rl.reshape(1, L), hl.reshape(1, L), window, roll1, mm_div,
        bitmask=bitmask,
    )

    def body(d, state):
        return phmm_step(d, state, c)

    def block(state, d):
        return phmm_rescale(state, d, c)

    z = jnp.zeros(qr.shape, jnp.float32)
    state = wavefront_sweep(
        n_diags, phmm_make_state(z, c.y0row), body, unroll=rescale_period,
        block_fn=block,
    )
    return phmm_finalize(state, c)
