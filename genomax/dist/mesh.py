"""Device mesh and multi-host process-group setup.

The reference is strictly single-process / single-GPU (it even hardcodes
`cudaSetDevice(1)`, smithWaterman.cu:391, pairHMM.cu:376) — this module
is the distribution layer it never had: `jax.distributed` for the
multi-host process group, a 1-D "data" mesh over the devices (the cards
of one host are joined all to all, so the mesh follows the data alone),
`shard_map` for the per-device kernels, an XLA all-gather to merge scores
(SURVEY.md §2.3-2.4).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host init. No-op on a single process with no coordinator —
    single-host callers can always call this unconditionally."""
    if coordinator is None and num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D data-parallel mesh over ``devices`` (default: all of
    ``jax.devices()``), or their first ``n_devices``. Raises ValueError
    when there are fewer devices than asked for."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def shard_map(f, mesh, in_specs, out_specs):
    """jax.shard_map with replication checking off: the per-shard kernels
    return identical all-gathered results by construction."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
