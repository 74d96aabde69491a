"""Time-block sequence parallelism: one long stream across a device mesh.

The reference's hot loop is strictly sequential over symbols
(viterbi_decoder_scalar.h:43-53); a frame is never split.  This module
adds the capability the reference lacks (SURVEY.md section 5
"long-context"): the symbol stream tiles across a 'time' mesh axis, each
device runs ACS on its tile after a *warm-up overlap* region received
from its left neighbour via ``lax.ppermute``, and traceback runs on each
tile after a *warm-down overlap* of decision rows received from the right
neighbour.  State metrics converge to the true path within ~5K trellis
steps (the classic truncated-Viterbi property; the block-parallel GPU
decoders in PAPERS.md use the same structure), so with ``overlap`` of a
few hundred steps the interior decode is exact with overwhelming
probability - and *exactly* exact on clean-enough channels.

Boundary semantics:
  * device 0 starts from the true reset metrics
    (viterbi_decoder_core.h:202-211); other devices start every state at
    the same constant and warm up.
  * the last device tracebacks from ``end_state`` (0 for tail-terminated
    streams); other devices traceback from state 0 through their
    right-halo decision rows first, discarding the halo bits.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import jax_core
from ..ops.jax_core import StaticSpec
from ..paths import DecodePath, select_path
from .mesh import make_mesh, pvary

__all__ = ["decode_stream_sp", "SpResult", "dryrun"]


class SpResult(tuple):
    """(bits, halo_mismatches) - the decode plus its convergence
    diagnostic.

    ``halo_mismatches`` counts disagreements over the *duplicated* halo
    bits: every interior tile boundary is decoded twice - once by the
    owner (after its warm-down through the right halo) and once by the
    left neighbour (whose warm-down walk passes through the same rows) -
    so an undersized ``overlap`` that would silently corrupt interior
    bits shows up as a nonzero count instead (SURVEY.md section 5
    long-context; the probabilistic guarantee in this module's
    docstring becomes observable).  0 means every boundary converged.
    """

    __slots__ = ()

    def __new__(cls, bits, halo_mismatches):
        return tuple.__new__(cls, (bits, halo_mismatches))

    @property
    def bits(self):
        return self[0]

    @property
    def halo_mismatches(self):
        return self[1]


def decode_stream_sp(spec: StaticSpec, mesh: Mesh, symbols: jnp.ndarray,
                     *, overlap: int, end_state: int = 0,
                     total_rows: int = None,
                     backend: Union[str, DecodePath] = "auto") -> jnp.ndarray:
    """Decode one long stream with its time axis sharded over 'time'.

    Args:
      symbols: (B, T, R) int32, T divisible by the 'time' axis size
        (pad the tail with neutral symbols; see ``total_rows``).
      overlap: warm-up/warm-down region in trellis steps (use >= 32*(K-1);
        the interior converges after ~5K steps).
      end_state: trellis state after the final transition (0 when
        tail-terminated, test_helpers.h:54-60).
      total_rows: true number of trellis rows before padding (default T);
        the traceback starts at the last true row.  Padding must be
        shorter than one tile minus the overlap.
      backend: the ACS path (:func:`..paths.select_path`) for the
        platform of the mesh's devices.  The tile walks stay on the XLA
        walk, which masks the stream padding.

    Returns per-row path bits (B, T) uint8: row t carries data bit
    t-(K-1) (viterbi_decoder_core.h:223-235), so data bits are rows
    [K-1, K-1+total_bits).

    If the mesh also has a 'data' axis, the frame axis B shards over it
    (frame-DP composed with time-SP on a 2-D mesh): each device decodes
    its (B/data, T/time) tile and halo exchange rides the 'time' axis
    only.
    """
    ntime = mesh.shape["time"]
    data_axis = "data" if "data" in mesh.shape else None
    B, T, R = symbols.shape
    if T % ntime:
        raise ValueError(f"T={T} not divisible by time-axis size {ntime}")
    L = T // ntime
    O = min(overlap, L)
    if total_rows is None:
        total_rows = T
    if total_rows <= (ntime - 1) * L + O and ntime > 1:
        raise ValueError("stream padding may not exceed one tile minus the "
                         "overlap region")

    right_perm = [(i, i + 1) for i in range(ntime - 1)]
    left_perm = [(i + 1, i) for i in range(ntime - 1)]

    vary_axes = ("time",) if data_axis is None else (data_axis, "time")

    # Boundary-state sentinel width: the traceback state IS the shift
    # register of the last K-1 path bits, so bit-equality over the
    # OLDEST K-1 halo rows is exactly equivalent to the two walks
    # entering the boundary in the same trellis state - which is the
    # invariant that makes the interior decode exact.  (The *newest*
    # halo bits are legitimately unconverged: the warm-down walk starts
    # unprimed there, so comparing all O rows would false-positive on
    # any noisy channel.)
    J = min(O, spec.K - 1)

    def _halo_mismatches(own_first, halo_pred, idx):
        """Convergence diagnostic: the oldest J halo rows are decoded
        both by their owner (own_first, authoritative) and by the left
        neighbour's warm-down walk (halo_pred, its discarded halo
        bits).  Ship the owner's copy left and count disagreements;
        psum to a replicated scalar.  Nonzero means an undersized
        ``overlap`` failed to converge at some tile boundary."""
        recv = jax.lax.ppermute(own_first, "time", left_perm)
        diff = jnp.sum((halo_pred != recv).astype(jnp.int32))
        # the last device has no right neighbour (its recv is zeros)
        diff = jnp.where(idx < ntime - 1, diff, 0)
        for ax in vary_axes:
            diff = jax.lax.psum(diff, ax)
        return diff

    path = select_path(spec, mesh.devices.flat[0].platform, backend)

    def shard_fn(sym_blk):
        # sym_blk: (B, L, R) - this device's tile.
        idx = jax.lax.axis_index("time")
        Bl = sym_blk.shape[0]

        # --- ACS with left-halo warm-up --------------------------------
        # Device 0 has no left neighbour: it decodes its own rows
        # straight from the reset metrics (exact, and cheaper - a
        # zero-symbol warm-up would *erase* the reset prior, since equal
        # branch metrics diffuse the state metrics flat within K-1
        # steps), and its discarded halo decision rows are zeros.
        halo_syms = jax.lax.ppermute(sym_blk[:, L - O:, :], "time",
                                     right_perm)          # left nbr's tail
        reset_m = pvary(jax_core.initial_metrics(spec, Bl), vary_axes)
        uniform_m = jnp.full_like(reset_m, spec.init_other)

        def acs(m0, syms_in):
            return path.update(spec, m0, syms_in)[1]

        def acs_first():
            return jnp.pad(acs(reset_m, sym_blk), ((O, 0), (0, 0), (0, 0)))

        def acs_interior():
            ext = jnp.concatenate([halo_syms, sym_blk], axis=1)
            return acs(uniform_m, ext)

        packed_ext = jax.lax.cond(idx == 0, acs_first, acs_interior)
        packed = packed_ext[O:]                            # (L, W, B) own rows

        # --- traceback with right-halo warm-down ------------------------
        halo_dec = jax.lax.ppermute(packed[:O], "time", left_perm)
        ext_dec = jnp.concatenate([packed, halo_dec], axis=0)  # (L+O, W, B)
        # Interior devices: walk O halo rows from state 0 to converge.
        # Last device: no halo (zeros arrived) - walk only own rows from
        # end_state.
        start_interior = pvary(jnp.zeros(Bl, jnp.int32), vary_axes)
        start_last = pvary(jnp.full((Bl,), end_state, jnp.int32), vary_axes)
        walk_full = jax_core.walk_scan(spec, ext_dec, start_interior)
        bits_interior = walk_full[:L]
        halo_pred = walk_full[L:]                # (O, B) duplicated bits
        # Last tile: mask stream-padding rows so the walk begins at the
        # true final row with end_state.
        grow = idx * L + jax.lax.iota(jnp.int32, L)
        bits_last = jax_core.walk_scan(spec, packed, start_last,
                                       valid=grow < total_rows)
        bits = jnp.where(idx == ntime - 1, bits_last, bits_interior)
        mism = _halo_mismatches(bits[:J], halo_pred[:J], idx)
        return jnp.swapaxes(bits, 0, 1), mism              # (B, L), ()

    # see frame_dp: the Pallas interpreter's state discharge trips the
    # vma check
    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(P(data_axis, "time", None),),
                       out_specs=(P(data_axis, "time"), P()),
                       check_vma=not path.interpret)
    bits, mism = jax.jit(fn)(symbols)
    return SpResult(bits, mism)


def dryrun(n_devices: int) -> None:
    """Tiny time-SP decode on an n_devices mesh; checks exact recovery of
    a clean tail-terminated stream against the sequential decode."""
    from ..codes import get_code
    from ..config import DecodeType, get_decode_config
    from ..ops import numpy_ref

    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    mesh = make_mesh((n_devices,), ("time",))

    rng = np.random.RandomState(1)
    ntime = n_devices
    nbytes = 16 * ntime
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    syms = numpy_ref.encode_bytes(code, data, config.soft_decision_high,
                                  config.soft_decision_low)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad_T = -(-T // ntime) * ntime
    sym_arr = np.zeros((1, pad_T, code.R), np.int32)
    sym_arr[0, :T] = syms.reshape(T, code.R)

    bits, mism = decode_stream_sp(spec, mesh, jnp.asarray(sym_arr),
                                  overlap=64, end_state=0, total_rows=T)
    assert int(mism) == 0, f"halo diagnostic reported {int(mism)} mismatches"
    got = np.asarray(bits)[0, code.K - 1:code.K - 1 + total_bits]
    expect = numpy_ref.bytes_to_bits(data)
    nerr = int((got != expect).sum())
    assert nerr == 0, f"time-SP decode had {nerr} bit errors"
