"""Sharded (multi-device) scoring: pair tiles data-parallel over the mesh,
per-pair results all-gathered — the reference's inter-alignment
parallelism (one CUDA block per pair, smithWaterman.cu:466 /
pairHMM.cu:616) promoted to the device level.

Everything runs under shard_map so each device executes the same wavefront
kernel on its shard of the packed tile batch (the leading NT dim of the
tiles); `jax.lax.all_gather` merges the (NT, 128) score tiles. The
PairHMM haplotype panel is replicated per device by construction (each
packed pair slot carries its own haplotype stream — cross-product
materialization happens at pack time or in the factored expansion),
matching the replicated-panel / sharded-reads layout in BASELINE.json.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import PartitionSpec as P

from genomax.config import SWConfig
from genomax.dist.mesh import DATA_AXIS, shard_map
from genomax.engine.executor import flatten_tiles


@functools.partial(
    jax.jit, static_argnames=("mesh", "n_diags", "cfg", "backend", "launch"),
)
def sw_forward_sharded(
    sx,  # (NT, NXs, 128)
    sy,  # (NT, NDs, 128)
    nx,  # (NT*128,)
    ny,
    *,
    mesh,
    n_diags: int = 0,
    cfg: SWConfig = SWConfig(),
    backend: str = "lax",
    launch: tuple | None = None,  # (group, cols) for the cuda backend
):
    """Batched SW over a device mesh. The tile dimension is sharded along
    the data axis; every device returns its shard's (NT_local, 128) scores
    and the full tile batch is all-gathered. NT must divide by #devices."""

    def shard_fn(sx_s, sy_s, nx_s, ny_s):
        if backend == "cuda":
            from genomax.kernels import cuda

            local = cuda.sw_tiles(sx_s, sy_s, nx_s, ny_s, cfg=cfg,
                                  launch=launch)
        else:
            from genomax.kernels.wavefront import sw_forward_dense

            local = sw_forward_dense(
                flatten_tiles(sx_s), flatten_tiles(sy_s), nx_s, ny_s,
                n_diags=n_diags, cfg=cfg,
            ).reshape(sx_s.shape[0], 128)
        return jax.lax.all_gather(local, DATA_AXIS, tiled=True)

    spec = P(DATA_AXIS)
    return shard_map(shard_fn, mesh, (spec,) * 4, P())(sx, sy, nx, ny)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_diags", "rescale_period", "backend",
                     "launch", "mm_div", "bitmask"),
)
def pairhmm_forward_sharded(
    rchar,  # (NT, NXs, 128)
    qr,
    mmv,
    gapm,
    qi,
    qd,
    qg,
    hap,  # (NT, NDs, 128)
    rl,  # (NT*128,)
    hl,
    *,
    mesh,
    n_diags: int = 0,
    rescale_period: int = 16,
    backend: str = "lax",
    launch: tuple | None = None,  # (group, cols) for the cuda backend
    mm_div: float = 1.0,
    bitmask: bool = False,
):
    """Batched PairHMM forward over a device mesh (see sw_forward_sharded)."""

    def shard_fn(rchar_s, qr_s, mmv_s, gapm_s, qi_s, qd_s, qg_s, hap_s,
                 rl_s, hl_s):
        if backend == "cuda":
            from genomax.kernels import cuda

            local = cuda.pairhmm_tiles(
                rchar_s, qr_s, mmv_s, gapm_s, qi_s, qd_s, qg_s, hap_s, rl_s,
                hl_s, launch=launch, mm_div=mm_div, bitmask=bitmask)
        else:
            from genomax.kernels.wavefront import phmm_forward_dense

            local = phmm_forward_dense(
                flatten_tiles(rchar_s), flatten_tiles(qr_s),
                flatten_tiles(mmv_s), flatten_tiles(gapm_s),
                flatten_tiles(qi_s), flatten_tiles(qd_s),
                flatten_tiles(qg_s), flatten_tiles(hap_s),
                rl_s, hl_s, n_diags=n_diags, rescale_period=rescale_period,
                mm_div=mm_div,
                bitmask=bitmask,
            ).reshape(rchar_s.shape[0], 128)
        return jax.lax.all_gather(local, DATA_AXIS, tiled=True)

    spec = P(DATA_AXIS)
    return shard_map(shard_fn, mesh, (spec,) * 10, P())(
        rchar, qr, mmv, gapm, qi, qd, qg, hap, rl, hl)
