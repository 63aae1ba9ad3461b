"""Multi-device dispatcher: the Engine's pack→dispatch→unpack pipeline
promoted to a device mesh (the multi-host streaming dispatcher of
BASELINE.json: read batches data-parallel over devices, haplotype data
replicated per pair slot by construction, scores all-gathered).

The reference is strictly single-GPU (SURVEY.md §2.3-2.4); this is the
distribution layer it never had. Per-host usage (multi-host pods):
call ``genomax.dist.mesh.initialize_distributed`` first, build the mesh
over ``jax.devices()``, and feed each process the full job list — every
host packs identically (numpy packing is cheap relative to scoring) and
``_put`` materializes only this process's addressable tile shards on
device (``jax.make_array_from_callback``), so the device feed is
host-sharded even though parsing is replicated; output order stays the
deterministic global packing order.
"""

from __future__ import annotations

import time

import numpy as np

from genomax.config import EngineConfig, PairHMMConfig, SWConfig
from genomax.dist.mesh import DATA_AXIS
from genomax.engine.executor import (Engine, RunStats, _run_buckets,
                                     phmm_bucket_stats, sw_bucket_stats)
from genomax.pack.bucketing import pack_sw_pairs, pad_tiles_to, unpack_scores


class ShardedEngine:
    """Engine twin that runs every bucket through the sharded
    (shard_map + all_gather) path on a device mesh."""

    def __init__(
        self,
        mesh,
        cfg: EngineConfig = EngineConfig(),
        sw_cfg: SWConfig = SWConfig(),
        phmm_cfg: PairHMMConfig = PairHMMConfig(),
    ):
        import genomax

        genomax.setup_compilation_cache()
        self.mesh = mesh
        self.n_devices = mesh.devices.size
        self.cfg = cfg
        self.sw_cfg = sw_cfg.validate()
        self.phmm_cfg = phmm_cfg
        self.backend = cfg.resolve_backend()
        if self.backend == "cuda":
            from genomax.kernels import cuda

            cuda.register()
        self.last_stats: RunStats | None = None

    def _put(self, arr):
        """Device placement: single-process -> plain transfer; multi-host
        -> global array assembled from this process's addressable shards
        only (tile dim sharded along the data axis)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        if jax.process_count() == 1:
            return jnp.asarray(arr)
        spec = P(DATA_AXIS, *([None] * (arr.ndim - 1)))
        sharding = NamedSharding(self.mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    def _put_replicated(self, arr):
        """Device placement, fully replicated (the factored pack's
        unique-row tables: every shard's gather needs all rows)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        if jax.process_count() == 1:
            return jnp.asarray(arr)
        sharding = NamedSharding(self.mesh, P())
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    # Feature parity with the single-device Engine: the same offload
    # masks, the same native post-passes, the same fp64 deep-negative
    # fallback — every execution path returns one consistent answer per
    # input (pairHMMmatrix.c:41-66). Packing is replicated per host, so
    # the native recomputes are deterministic across hosts.
    _max_len = Engine._max_len
    _stream_band = Engine._stream_band
    _sw_offload_mask = Engine._sw_offload_mask
    _sw_offload_post = Engine._sw_offload_post
    _phmm_pack = Engine._phmm_pack
    _phmm_offload_mask = Engine._phmm_offload_mask
    _phmm_offload_post = Engine._phmm_offload_post
    _phmm_native_subset = Engine._phmm_native_subset
    _phmm_fallback = Engine._phmm_fallback

    def sw_scores(self, pairs) -> np.ndarray:
        from genomax.dist.sharded import sw_forward_sharded

        stats = RunStats(n_jobs=len(pairs))
        off = self._sw_offload_mask(pairs)
        t0 = time.perf_counter()
        buckets = [
            pad_tiles_to(b, self.n_devices)
            for b in pack_sw_pairs(
                pairs, job_mask=None if off is None else ~off,
                stream_band=self._stream_band(),
            )
        ]
        stats.pack_s = time.perf_counter() - t0
        stats.buckets = len(buckets)
        sw_bucket_stats(stats, buckets)
        t0 = time.perf_counter()

        def dispatch(b):
            # Nibble-compressed transfer, same contract as the local
            # engine: ship 4-bit codes, expand AFTER placement —
            # elementwise, so it runs SPMD on the tile-sharded array
            # with no collectives (like expand_byte_quals below).
            from genomax.pack.nibble import ship_stream, stream_bytes

            ship = self._put
            launch = None
            if self.backend == "cuda":
                from genomax.kernels import cuda

                launch = cuda.sw_launch(b)
                if self.cfg.nibble_transfer:
                    from genomax.pack.nibble import (build_code_lut,
                                                     make_shipper)

                    ship = make_shipper(
                        self._put,
                        lut=build_code_lut(b.sx, stream_bytes(b.sy)))
            return sw_forward_sharded(
                ship(b.sx),
                ship_stream(ship, b.sy),
                self._put(b.nx.reshape(-1, 128)).reshape(-1),
                self._put(b.ny.reshape(-1, 128)).reshape(-1),
                mesh=self.mesh,
                n_diags=-(-b.max_diags // 32) * 32,
                cfg=self.sw_cfg,
                backend=self.backend,
                launch=launch,
            )

        results = _run_buckets("sw-sharded", buckets, dispatch)
        stats.exec_s = time.perf_counter() - t0
        out = unpack_scores(buckets, results, len(pairs), np.int32)
        self._sw_offload_post(pairs, out, off, stats)
        self.last_stats = stats
        return out

    def pairhmm(self, batches) -> np.ndarray:
        from genomax.dist.sharded import pairhmm_forward_sharded

        stats = RunStats()
        off = self._phmm_offload_mask(batches)
        t0 = time.perf_counter()
        buckets, n = self._phmm_pack(batches, off)
        buckets = [pad_tiles_to(b, self.n_devices) for b in buckets]
        stats.pack_s = time.perf_counter() - t0
        stats.n_jobs = n
        stats.buckets = len(buckets)
        phmm_bucket_stats(stats, buckets)
        t0 = time.perf_counter()

        def dispatch(b):
            from genomax.pack.expand import expand_byte_quals, expand_factored

            if b.rchar_u is not None:
                # factored pack: unique-row tables replicated, gather
                # indices tile-sharded; the device-side rebuild
                # (expand_factored) is a per-shard gather from the
                # replicated tables — SPMD, no collectives.
                rchar, *quals, hap = expand_factored(
                    self._put_replicated(b.rchar_u),
                    self._put_replicated(b.qb_u),
                    self._put_replicated(b.hap_u),
                    self._put(b.ridx),
                    self._put(b.hidx),
                    float(self.phmm_cfg.phred_offset),
                )
            else:
                if b.qb is not None:
                    # byte_quals: expand AFTER placement — elementwise,
                    # so it runs SPMD on the tile-sharded qb with no
                    # collectives
                    quals = expand_byte_quals(
                        self._put(b.qb), float(self.phmm_cfg.phred_offset)
                    )
                else:
                    quals = tuple(self._put(a) for a in (
                        b.qr, b.mmv, b.gapm, b.qi, b.qd, b.qg))
                # Bitmask codes are 4-bit: nibble-pack rchar + the hap
                # stream (no remap), expand post-placement like qb above.
                # Device backend only, like the local engine.
                from genomax.pack.nibble import make_shipper

                ship = make_shipper(
                    self._put,
                    four_bit=(b.bitmask_codes and self.cfg.nibble_transfer
                              and self.backend == "cuda"),
                )
                rchar, hap = ship(b.rchar), ship(b.hap)
            launch = None
            if self.backend == "cuda":
                from genomax.kernels import cuda

                launch = cuda.pairhmm_launch(b)
            return pairhmm_forward_sharded(
                rchar,
                *quals,
                hap,
                self._put(b.rl.reshape(-1, 128)).reshape(-1),
                self._put(b.hl.reshape(-1, 128)).reshape(-1),
                mesh=self.mesh,
                n_diags=-(-b.max_diags // self.cfg.rescale_period)
                * self.cfg.rescale_period,
                rescale_period=self.cfg.rescale_period,
                backend=self.backend,
                launch=launch,
                mm_div=self.phmm_cfg.mm_div,
                bitmask=b.bitmask_codes,
            )

        results = _run_buckets("pairhmm-sharded", buckets, dispatch)
        stats.exec_s = time.perf_counter() - t0
        out = unpack_scores(buckets, results, n, np.float32)
        out, native_done = self._phmm_offload_post(batches, out, off, stats)
        out = self._phmm_fallback(batches, out, stats, skip=native_done)
        self.last_stats = stats
        return out
