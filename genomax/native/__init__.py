"""ctypes loader for the native golden library (genomax/native/golden.cpp).

Builds the shared library from golden.cpp on first use with g++ (into
_golden.so next to the source, listed in .gitignore; rebuilt when the
source is newer); every entry point has a pure-python fallback so the
package works without a toolchain. ``build()`` compiles it and raises
when that fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "golden.cpp")
_LIB = os.path.join(_DIR, "_golden.so")
_lock = threading.Lock()
_lib = None


def build() -> str:
    # Compile into a temporary file and move it into place: concurrent
    # first uses (test workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


def load(rebuild: bool = False):
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        try:
            if rebuild or not os.path.exists(_LIB) or os.path.getmtime(
                _LIB
            ) < os.path.getmtime(_SRC):
                build()
            lib = ctypes.CDLL(_LIB)
        except (OSError, subprocess.CalledProcessError):
            return None

        lib.gx_sw_score.restype = ctypes.c_int32
        lib.gx_sw_score.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        lib.gx_sw_scores_batch.restype = None
        lib.gx_sw_scores_batch.argtypes = [
            u8p, i64p, u8p, i64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p,
        ]
        lib.gx_pairhmm_batch.restype = None
        lib.gx_pairhmm_batch.argtypes = [
            u8p, i64p, f64p, f64p, f64p, f64p, u8p, i64p, i64p, i64p,
            ctypes.c_int64, f64p, ctypes.c_double,
        ]
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        c64 = ctypes.c_int64
        lib.gx_pack_sw_fill.restype = None
        lib.gx_pack_sw_fill.argtypes = [
            u8p, i64p, u8p, i64p, i64p, c64, c64, c64, c64,
            i8p, i8p, i32p, i32p,
        ]
        lib.gx_pack_phmm_fill.restype = None
        lib.gx_pack_phmm_fill.argtypes = [
            u8p, i64p, u8p, u8p, u8p, u8p, u8p, i64p, i64p, i64p, i64p,
            c64, c64, c64, c64, ctypes.c_double,
            i8p, f32p, f32p, f32p, f32p, f32p, f32p, i8p, i32p, i32p,
        ]
        lib.gx_pack_phmm_fill_bytes.restype = None
        lib.gx_pack_phmm_fill_bytes.argtypes = [
            u8p, i64p, u8p, u8p, u8p, u8p, u8p, i64p, i64p, i64p, i64p,
            c64, c64, c64, c64,
            i8p, i8p, i8p, i32p, i32p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _concat_with_offsets(items):
    off = np.zeros(len(items) + 1, dtype=np.int64)
    for i, it in enumerate(items):
        off[i + 1] = off[i] + len(it)
    data = np.frombuffer(b"".join(bytes(it) for it in items), dtype=np.uint8)
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    return np.ascontiguousarray(data), off


def sw_scores_native(pairs, cfg=None) -> np.ndarray:
    """Batch SW scores through the native golden model (fp-free int32)."""
    from genomax.config import SWConfig

    cfg = cfg or SWConfig()
    lib = load()
    if lib is None:
        from genomax.kernels import oracle

        return oracle.sw_scores_pairs(pairs, cfg)
    sx_data, sx_off = _concat_with_offsets([p.sx for p in pairs])
    sy_data, sy_off = _concat_with_offsets([p.sy for p in pairs])
    out = np.zeros(len(pairs), dtype=np.int32)
    lib.gx_sw_scores_batch(
        sx_data, sx_off, sy_data, sy_off, len(pairs),
        cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend, out,
    )
    return out


def pairhmm_native(batches, phred_offset: float = 33.0,
                   gatk_emission: bool = False) -> np.ndarray:
    """Batch PairHMM log10 likelihoods (fp64) in reference output order.
    gatk_emission: True = Qr/3 mismatch emission (the real GATK; see
    PairHMMConfig.gatk_emission), False = reference parity."""
    from genomax.io.phred import phred_to_error_prob
    from genomax.pack.bucketing import _reject_bad_read

    # Same loud validation as the packers. Load-bearing here, not just
    # consistency: gx_pairhmm_batch indexes the flat quality arrays
    # with the BASES offsets (golden.cpp), so a read whose qual strings
    # are shorter than its bases would read past the allocation.
    for b in batches:
        for rd in b.reads:
            _reject_bad_read(rd, phred_offset)

    lib = load()
    if lib is None:
        from genomax.config import PairHMMConfig
        from genomax.kernels import oracle

        cfg = PairHMMConfig(phred_offset=phred_offset,
                            gatk_emission=gatk_emission)
        return np.concatenate(
            [oracle.pairhmm_batch_log10(b, cfg) for b in batches])

    reads, haps, job_r, job_h = [], [], [], []
    quals = [[], [], [], []]
    for b in batches:
        r0, h0 = len(reads), len(haps)
        for rd in b.reads:
            reads.append(rd.bases)
            for qlist, raw in zip(quals, (rd.base_q, rd.ins_q, rd.del_q, rd.gcp_q)):
                qlist.append(
                    phred_to_error_prob(np.frombuffer(raw, np.uint8), phred_offset)
                )
        haps.extend(b.haplotypes)
        for ri in range(len(b.reads)):
            for hi in range(len(b.haplotypes)):
                job_r.append(r0 + ri)
                job_h.append(h0 + hi)

    read_data, read_off = _concat_with_offsets(reads)
    hap_data, hap_off = _concat_with_offsets(haps)
    qarr = [
        np.ascontiguousarray(np.concatenate(q) if q else np.zeros(1)) for q in quals
    ]
    out = np.zeros(len(job_r), dtype=np.float64)
    lib.gx_pairhmm_batch(
        read_data, read_off, qarr[0], qarr[1], qarr[2], qarr[3],
        hap_data, hap_off,
        np.ascontiguousarray(np.array(job_r, np.int64)),
        np.ascontiguousarray(np.array(job_h, np.int64)),
        len(job_r), out, 3.0 if gatk_emission else 1.0,
    )
    return out
