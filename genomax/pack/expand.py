"""On-device expansion of the compact PairHMM transfer forms.

The packers (pack/bucketing.py) can ship raw phred bytes
(PairHMMPacked.qb) and a factored read x haplotype cross-product
(PairHMMPacked.rchar_u / qb_u / hap_u + ridx / hidx). These jitted
functions rebuild the kernels' (NT, rows, 128) tiles on the device, with
plain jnp ops, bit-identical to the host packs (tests/test_factored.py,
tests/test_native.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("phred_offset",))
def expand_byte_quals(qb, phred_offset: float = 33.0):
    """Expand raw phred+33 quality bytes (PairHMMPacked.qb,
    (NT, 4, NXs, 128) int8, planes base/ins/del/gcp) into the six fp32
    tables the kernels consume — ON DEVICE, so the host ships ~5.6x
    fewer bytes per batch (the reference decodes on host into doubles,
    pairHMMmatrix.c qual-to-prob; genomax moves the decode past the
    host-device boundary).

    LUT entries below the phred offset are exact 0.0: real quality
    bytes are >= offset (printable phred+33), so only layout pads
    (byte 0) hit them — preserving the pad-decay invariant (all six
    tables exactly 0 at pad cells, byte-identical to the fp32 packers'
    calloc pages). mmv/gapm are additionally gated on the pad mask
    since their pad value must be 0, not 1. fp32 rounding note: the
    host packer computes 1-(Qi+Qd) in fp64 then casts; here the sum is
    fp32 — differs by <=1 ulp, far inside the 1e-4 parity envelope.
    """
    # The pad-decay invariant below zeroes LUT entries < phred_offset;
    # with offset < 1 NOTHING is zeroed, so a legitimate qual byte 0
    # would collide with the byte-0 pad sentinel and mark live cells
    # dead (ADVICE r3). No real encoding has offset < 33.
    if phred_offset < 1.0:
        raise ValueError(
            f"phred_offset={phred_offset} < 1 breaks the byte-0 pad "
            "sentinel (lut[0] must be exactly 0)")
    lut_np = np.power(10.0, -(np.arange(256) - phred_offset) / 10.0)
    lut_np[: max(0, int(np.ceil(phred_offset)))] = 0.0
    lut = jnp.asarray(lut_np.astype(np.float32))
    idx = qb.astype(jnp.uint8).astype(jnp.int32)
    qr = jnp.take(lut, idx[:, 0], axis=0)
    qi = jnp.take(lut, idx[:, 1], axis=0)
    qd = jnp.take(lut, idx[:, 2], axis=0)
    qg = jnp.take(lut, idx[:, 3], axis=0)
    live = idx[:, 0] != 0
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    mmv = jnp.where(live, one - (qi + qd), zero)
    gapm = jnp.where(live, one - qg, zero)
    return qr, mmv, gapm, qi, qd, qg


@functools.partial(jax.jit, static_argnames=("phred_offset",))
def expand_factored(rchar_u, qb_u, hap_u, ridx, hidx,
                    phred_offset: float = 33.0):
    """Rebuild job tiles from a FACTORED pack (PairHMMPacked.rchar_u /
    qb_u / hap_u + ridx/hidx gather indices): the read×haplotype
    cross-product ships each unique read/hap once and this gathers +
    transposes them back into the sublane-major (NT, rows, 128) tiles —
    on DEVICE at HBM rate, so the host ships ~NH-fold fewer bytes than
    even the byte-qual pack. Returns (rchar, six qual tables, hap)
    bit-identical to the unfactored tiles (tests/test_nibble.py)."""
    rchar = jnp.swapaxes(jnp.take(rchar_u, ridx, axis=0), 1, 2)
    qb = jnp.transpose(jnp.take(qb_u, ridx, axis=0), (0, 2, 3, 1))
    hap = jnp.swapaxes(jnp.take(hap_u, hidx, axis=0), 1, 2)
    return (rchar,) + expand_byte_quals(qb, phred_offset) + (hap,)
