"""Nibble-compressed host->device transfer for SW code tiles.

The SW kernels consume sequence codes ONLY through equality tests
(`syw == sxb`, kernels/wavefront.py sw_step; the reference likewise,
antidiagonalSmithWaterman.c:309-335) plus the pad-decay contract: x pads
are code 1, stream pads code 0, and packers reject bytes 0/1 inside
sequences. Scores are therefore invariant under any bijective remap of
the sequence alphabet that fixes the two pad codes — so when a bucket's
alphabet has <= 14 distinct symbols (always true for DNA: ACGTN plus
the trailing-'\n' quirk byte is 6), we remap bytes to codes 2..15 and
ship TWO rows per byte. That halves the SW host->device payload, but the
remap and the packing run on the host; EngineConfig.nibble_transfer is
off by default because they cost more than the copy they save.

Contract: `build_code_lut` over every array of the dispatch (one shared
alphabet — x codes must compare equal to the SAME stream bytes after
the remap), `nibble_pack` each on host, `expand_nibbles` each on device
(pure elementwise+reshape: safe inside shard_map, fused by XLA).
Expansion reproduces the int8 tile bit-exactly, so every kernel and its
layout is untouched.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from genomax.kernels.wavefront import PAD_STREAM, PAD_X

MAX_SYMBOLS = 14  # nibble values 2..15 (0/1 are the pad codes)


def build_code_lut(*arrays: np.ndarray) -> np.ndarray | None:
    """uint8[256] remap table over the distinct non-pad bytes of
    ``arrays``, or None when the alphabet needs more than 14 codes
    (arbitrary-byte inputs: caller ships uncompressed). One bincount
    pass per array (~GB/s); identity on the pad codes 0/1."""
    counts = np.zeros(256, dtype=np.int64)
    for a in arrays:
        counts += np.bincount(a.reshape(-1).view(np.uint8), minlength=256)
    present = np.flatnonzero(counts[2:]) + 2
    if len(present) > MAX_SYMBOLS:
        return None
    lut = np.zeros(256, dtype=np.uint8)
    lut[PAD_X] = PAD_X
    lut[PAD_STREAM] = PAD_STREAM
    lut[present] = np.arange(2, 2 + len(present), dtype=np.uint8)
    return lut


def nibble_pack(arr: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """(NT, R, 128) int8 codes -> (NT, ceil(R/2), 128) uint8: remap
    through ``lut``, then row 2k in the low nibble, row 2k+1 in the
    high. An odd R gets one implicit pad row (dropped by the expander's
    slice)."""
    m = lut[arr.view(np.uint8) if arr.dtype == np.int8 else arr.astype(np.uint8)]
    nt, r, lanes = m.shape
    if r % 2:
        m = np.concatenate(
            [m, np.zeros((nt, 1, lanes), dtype=np.uint8)], axis=1
        )
    return m[:, 0::2] | (m[:, 1::2] << 4)


def nibble_pack_4bit(arr: np.ndarray) -> np.ndarray:
    """nibble_pack for arrays whose values are ALREADY 4-bit — the
    PairHMM match-bitmask codes ({0,1,2,4,8,15}, pack_pairhmm_batches
    `_bitmask_translate`): no remap, just two rows per byte. Guarded:
    a value > 15 would silently corrupt its neighbor's high nibble, so
    refuse loudly (one vectorized max pass)."""
    if arr.size and int(arr.view(np.uint8).max()) > 0xF:
        raise ValueError("nibble_pack_4bit: array has values > 15")
    return nibble_pack(arr, _IDENTITY_LUT)


_IDENTITY_LUT = np.arange(256, dtype=np.uint8)


@functools.partial(jax.jit, static_argnames=("rows",))
def expand_nibbles(packed, rows: int):
    """Device-side inverse of nibble_pack: (NT, ceil(rows/2), 128)
    uint8 -> (NT, rows, 128) int8, interleaving low/high nibbles back
    into consecutive sublane rows. Elementwise + reshape only (SPMD-
    safe; no collectives)."""
    import jax.numpy as jnp

    lo = (packed & 0xF).astype(jnp.int8)
    hi = (packed >> 4).astype(jnp.int8)
    full = jnp.stack((lo, hi), axis=2).reshape(
        packed.shape[0], -1, packed.shape[-1]
    )
    return full[:, :rows]


def stream_bytes(sy):
    """The host byte array backing a stream — the band for a
    StreamBand, the full buffer otherwise (LUT building, host math)."""
    from genomax.pack.bucketing import StreamBand

    return sy.band if isinstance(sy, StreamBand) else sy


def ship_stream(ship, sy):
    """Place a reversed stream buffer on device through ``ship`` (a
    make_shipper function or plain put). For a StreamBand, ship only
    the live band and reconstruct the full (NT, NDs, 128) buffer on
    device: zeros + one static-slice insert — bit-identical to shipping
    the full host buffer, at a 2-3.5x smaller H2D payload (everything
    outside [lo, A) is PAD_STREAM = 0 by the pack's construction)."""
    from genomax.pack.bucketing import StreamBand

    if not isinstance(sy, StreamBand):
        return ship(sy)
    import jax.numpy as jnp

    dev = ship(sy.band)
    rows = sy.band.shape[1]
    # zero-pad back to [0, nds): everything outside the band is
    # PAD_STREAM = 0. jnp.pad touches only the row dim, so a tile-dim
    # sharding (the sharded engine's _put) propagates through unchanged.
    return jnp.pad(dev, ((0, 0), (sy.lo, sy.nds - sy.lo - rows), (0, 0)))


def make_shipper(put, *, lut=None, four_bit: bool = False):
    """The one host->device shipping contract for code tiles, shared by
    the local and sharded engines (four call sites; keeping it here
    stops the variants drifting). `put` is the placement function
    (jnp.asarray locally, the sharded engine's tile-sharded _put on a
    mesh). Returns a function that nibble-compresses on host, places
    the half-size buffer, and expands on device:

    - lut: remap table from build_code_lut (SW tiles, <=14-symbol
      alphabets; None = alphabet too wide, ships raw).
    - four_bit: codes are already 4-bit (PairHMM match-bitmask packs),
      pack directly with no remap.

    Falls back to plain `put` when neither applies."""
    if lut is not None:
        return lambda a: expand_nibbles(put(nibble_pack(a, lut)), a.shape[1])
    if four_bit:
        return lambda a: expand_nibbles(put(nibble_pack_4bit(a)), a.shape[1])
    return put
