"""Frame data-parallel decoding over a device mesh.

Frames are fully independent, so this is the mesh analogue of the
reference's thread-pool task parallelism (run_benchmark.cpp:193-244): the
batch axis is sharded across the 'data' mesh axis via shard_map, every
device runs the identical compiled decode on its shard, and aggregate
statistics (total bit errors for BER) reduce with a psum over the mesh -
hosts only see the final scalars.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DecodeType, get_decode_config
from ..ops import jax_core
from ..paths import DecodePath, select_path
from .mesh import make_mesh, pvary

__all__ = ["decode_dp", "dryrun"]


def decode_dp(spec: jax_core.StaticSpec, mesh: Mesh, symbols: jnp.ndarray,
              total_bits: int, *, backend: Union[str, DecodePath] = "auto",
              reference_bits: Optional[jnp.ndarray] = None
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Decode (B, T, R) symbols with B sharded over mesh axis 'data'.

    ``backend``: the decode path (:func:`..paths.select_path`) for the
    platform of the mesh's devices.

    Returns (bits (B, total_bits) uint8 sharded over 'data',
    total_bit_errors () int32 - a psum over the mesh when
    ``reference_bits`` is given, else 0).
    """
    path = select_path(spec, mesh.devices.flat[0].platform, backend)

    def shard_fn(sym_blk, ref_blk=None):
        Bl = sym_blk.shape[0]
        bits, _, _ = path.decode(
            spec, pvary(jax_core.initial_metrics(spec, Bl), "data"), sym_blk,
            pvary(jnp.zeros(Bl, jnp.int32), "data"), total_bits)
        if ref_blk is None:
            errs = pvary(jnp.zeros((), jnp.int32), "data")
        else:
            errs = jnp.sum((bits != ref_blk).astype(jnp.int32))
        return bits, jax.lax.psum(errs, "data")

    in_specs = (P("data", None, None),)
    args = (symbols,)
    if reference_bits is not None:
        in_specs += (P("data", None),)
        args += (reference_bits,)
    # the Pallas interpreter's state discharge drops the varying-axis
    # type of untouched refs, which the vma check rejects
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                       out_specs=(P("data", None), P()),
                       check_vma=not path.interpret)
    return jax.jit(fn)(*args)


def dryrun(n_devices: int) -> None:
    """One full frame-DP + time-SP step on an n_devices mesh (driver hook).

    Uses a 2D mesh (data x time) when n_devices is even: frames shard over
    'data' (this module) and one long stream decodes over 'time'
    (block_sp, with ppermute halo exchange), exercising every sharding and
    collective the framework uses.
    """
    from ..codes import get_code
    from ..ops import numpy_ref
    from . import block_sp

    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)

    # --- frame-DP leg -----------------------------------------------------
    dp = n_devices
    mesh = make_mesh((dp,), ("data",))
    rng = np.random.RandomState(0)
    B, nbytes = 2 * dp, 8
    data = rng.randint(0, 256, (B, nbytes), dtype=np.uint8)
    syms = np.stack([
        numpy_ref.encode_bytes(code, d, config.soft_decision_high,
                               config.soft_decision_low) for d in data
    ])
    T = syms.shape[1] // code.R
    total_bits = nbytes * 8
    ref_bits = np.unpackbits(data, axis=1, bitorder="big")
    bits, errs = decode_dp(spec, mesh, jnp.asarray(syms.reshape(B, T, code.R)),
                           total_bits, reference_bits=jnp.asarray(ref_bits))
    assert int(errs) == 0, f"frame-DP decode had {int(errs)} bit errors"

    # --- mesh-BER leg: one tiny data-parallel point (psum'd budgets) -------
    from .. import ber
    import jax
    p = ber.measure_point(code, config, 4.0, key=jax.random.PRNGKey(0),
                          block_bits=128, batch=2, max_bits=dp * 2 * 128,
                          max_errors=10_000, mesh=mesh)
    assert p.total_bits >= dp * 2 * 128, p

    # --- time-SP leg -------------------------------------------------------
    if n_devices >= 2:
        block_sp.dryrun(n_devices)

    # --- 2-D composed leg: frame-DP x time-SP on one mesh -------------------
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = make_mesh((2, n_devices // 2), ("data", "time"))
        ntime = n_devices // 2
        nbytes2 = 16 * ntime
        d2 = rng.randint(0, 256, (2, nbytes2), dtype=np.uint8)
        s2 = np.stack([
            numpy_ref.encode_bytes(code, d, config.soft_decision_high,
                                   config.soft_decision_low) for d in d2
        ])
        bits2 = nbytes2 * 8
        T2 = bits2 + code.K - 1
        pad_T2 = -(-T2 // ntime) * ntime
        arr2 = np.zeros((2, pad_T2, code.R), np.int32)
        arr2[:, :T2] = s2.reshape(2, T2, code.R)
        out2, mism2 = block_sp.decode_stream_sp(spec, mesh2,
                                                jnp.asarray(arr2),
                                                overlap=64, total_rows=T2)
        assert int(mism2) == 0, "halo diagnostic reported mismatches"
        got2 = np.asarray(out2)[:, code.K - 1:code.K - 1 + bits2]
        expect2 = np.unpackbits(d2, axis=1, bitorder="big")
        nerr2 = int((got2 != expect2).sum())
        assert nerr2 == 0, f"2-D mesh decode had {nerr2} bit errors"
