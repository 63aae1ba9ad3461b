"""Test configuration: the CPU backend with 8 virtual devices, so the suite
(the lax twins, the host emulation of the CUDA kernels, and the sharded
paths on a multi-device mesh) runs without a GPU — the strategy SURVEY.md
§4 derives from the reference's differential-testing approach. This is
the only place virtual devices are provisioned.

Tests marked ``gpu`` need an NVIDIA GPU; they skip elsewhere (decided in
the ``gpu`` fixture, at run time) and run on the card with
``python -m pytest tests/ -m gpu``.
"""

import functools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import genomax  # noqa: E402

# Same cache rule as the engines: $JAX_COMPILATION_CACHE_DIR, else the
# checkout's own directory.
genomax.setup_compilation_cache()

import jax  # noqa: E402
import pytest  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


@pytest.fixture()
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with: python -m pytest "
                    "tests/ -m gpu on the card)")


@functools.partial(jax.jit, static_argnames=("cfg", "launch"))
def _lax_sw_tiles(sx, sy, nx, ny, *, cfg, launch):
    """The lax twin with the SW kernel's tile signature. The anchor
    bounds every pair's diagonal count (genomax/layout.py), so it is a
    static loop bound even inside shard_map."""
    from genomax.engine.executor import flatten_tiles
    from genomax.kernels.wavefront import sw_forward_dense
    from genomax.layout import MAX_UNROLL

    del launch
    n_diags = sy.shape[1] - sx.shape[1] - MAX_UNROLL
    return sw_forward_dense(flatten_tiles(sx), flatten_tiles(sy), nx, ny,
                            n_diags=n_diags, cfg=cfg).reshape(sx.shape[0], 128)


@functools.partial(jax.jit, static_argnames=("launch", "mm_div", "bitmask"))
def _lax_pairhmm_tiles(rchar, qr, mmv, gapm, qi, qd, qg, hap, rl, hl, *,
                       launch, mm_div=1.0, bitmask=False):
    from genomax.engine.executor import flatten_tiles
    from genomax.kernels.wavefront import phmm_forward_dense
    from genomax.layout import MAX_UNROLL

    del launch
    n_diags = hap.shape[1] - rchar.shape[1] - MAX_UNROLL
    tiles = [flatten_tiles(a) for a in (rchar, qr, mmv, gapm, qi, qd, qg,
                                        hap)]
    return phmm_forward_dense(*tiles, rl, hl, n_diags=n_diags,
                              mm_div=mm_div, bitmask=bitmask
                              ).reshape(rchar.shape[0], 128)


def _host_sw_tiles(sx, sy, nx, ny, *, cfg, launch):
    """The host emulation of the SW kernel, as a JAX callback."""
    import jax.numpy as jnp

    from genomax.kernels import cuda

    out = jax.ShapeDtypeStruct((sx.shape[0], 128), jnp.int32)
    return jax.pure_callback(
        lambda *a: cuda.host_sw_tiles(*a, cfg=cfg, launch=launch),
        out, sx, sy, nx, ny)


def _host_pairhmm_tiles(*arrays, launch, mm_div=1.0, bitmask=False):
    import jax.numpy as jnp

    from genomax.kernels import cuda

    out = jax.ShapeDtypeStruct((arrays[0].shape[0], 128), jnp.float32)
    return jax.pure_callback(
        lambda *a: cuda.host_pairhmm_tiles(*a, launch=launch, mm_div=mm_div,
                                           bitmask=bitmask),
        out, *arrays)


@pytest.fixture(params=["lax", "host"])
def cuda_twin(request, monkeypatch):
    """Run the engines' cuda path (launch shapes, transfer ladder, unpack,
    offload) on the CPU, with the kernel entry points replaced by the lax
    twin or by the host emulation of the kernels' schedule."""
    from genomax.kernels import cuda

    twins = {"lax": (_lax_sw_tiles, _lax_pairhmm_tiles),
             "host": (_host_sw_tiles, _host_pairhmm_tiles)}
    sw, ph = twins[request.param]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda, "register", lambda: None)
    monkeypatch.setattr(cuda, "sw_tiles", sw)
    monkeypatch.setattr(cuda, "pairhmm_tiles", ph)
    jax.clear_caches()  # jitted callers must retrace with this twin
    yield request.param
    jax.clear_caches()
