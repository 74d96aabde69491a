"""Device-resident BER measurement (the run_snr_ber engine).

The reference measures BER with a host loop: generate a block, encode,
add noise, decode, count errors, repeat until a bit budget / error budget
is hit (run_snr_ber.cpp:335-379).  A host round-trip costs far more than
one trellis step, so here the *entire* Eb/No point runs on device: a
``lax.while_loop`` generates batches of frames with the on-device PRNG,
pushes them through encode -> AWGN -> quantise -> ACS -> chainback, and
accumulates (total_bits, bit_errors) in the carry.  The host reads back
two scalars per point.

Stopping semantics mirror get_test_range / run_test
(run_snr_ber.cpp:220-233, 318-396): per point, generate until
``max_bits`` or ``max_errors``; per sweep, advance Eb/No in 0.5 dB steps
from 0 until a zero-error point or the point cap.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .codes import CodeSpec
from .config import DecoderConfig
from .ops import jax_core
from .parallel.mesh import pvary
from .paths import DecodePath, select_path
from .utils import testsig

__all__ = ["BerPoint", "SweepResult", "measure_point",
           "measure_point_host_chain", "sweep"]


@dataclasses.dataclass
class BerPoint:
    EbNo_dB: float
    ber: float
    total_bits: int
    total_bit_errors: int


@dataclasses.dataclass
class SweepResult:
    code: CodeSpec
    points: List[BerPoint]

    @property
    def EbNo_dB(self):
        return [p.EbNo_dB for p in self.points]

    @property
    def ber(self):
        return [p.ber for p in self.points]


def default_max_bits(code: CodeSpec, scale: float = 1.0) -> int:
    """Bit budget per point: 1e9 / (R * 2^(K-1)) (run_snr_ber.cpp:220-233)."""
    runtime_scale = code.R * (1 << (code.K - 1))
    return int(math.ceil(scale * (1e9 / runtime_scale)))


@functools.partial(jax.jit,
                   static_argnums=(0, 1, 4, 5, 6))
def _point_device(spec: jax_core.StaticSpec, code: CodeSpec, key,
                  EbNo_dB, block_bits: int, batch: int,
                  path: DecodePath, stop_bits, stop_errors,
                  bits_done0, errors0):
    """One resumable slice of a BER point: generate/decode blocks until
    the running totals pass the (traced) ``stop_bits`` / ``stop_errors``
    thresholds.  Thresholds and carried totals are data, not trace
    constants, so the wall-clock-timeout host loop (run_snr_ber.cpp's
    third stopping rule, :361-379) re-enters one compiled program with a
    smaller quota instead of recompiling per slice."""
    config_rate = code.R

    def decode(syms):
        return _decode_for_ber(spec, path, syms, block_bits)

    def cond(carry):
        key, bits_done, errors = carry
        return jnp.logical_and(bits_done < stop_bits, errors < stop_errors)

    def body(carry):
        key, bits_done, errors = carry
        key, k1, k2 = jax.random.split(key, 3)
        tx = jax.random.bernoulli(k1, 0.5, (batch, block_bits)).astype(
            jnp.uint8)
        floats = testsig.modulate_encode(code, tx, True)
        syms = testsig.awgn_quantize(floats, k2, EbNo_dB, config_rate,
                                     spec)
        rx = decode(syms)
        errors = errors + testsig.count_bit_errors(rx, tx)
        return key, bits_done + batch * block_bits, errors

    key, bits_done, errors = jax.lax.while_loop(
        cond, body,
        (key, jnp.asarray(bits_done0, jnp.int32),
         jnp.asarray(errors0, jnp.int32)))
    return key, bits_done, errors


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 5, 6, 11))
def _point_device_dp(spec: jax_core.StaticSpec, code: CodeSpec, key,
                     EbNo_dB, block_bits: int, batch_per_dev: int,
                     path: DecodePath, stop_bits, stop_errors,
                     bits_done0, errors0, mesh):
    """Mesh-data-parallel BER point slice: every device runs the
    generate->encode->AWGN->decode->count loop on its own sub-batch
    (device-folded PRNG streams), and the stopping condition checks the
    *psum'd* global totals each iteration, so all devices take the same
    number of steps and the budgets are global - the mesh replacement
    for the reference's thread-pooled BER tasks (run_snr_ber.cpp:255-277;
    SURVEY.md section 5: "psum for BER/error reductions across hosts")."""
    from jax.sharding import PartitionSpec as P

    ndev = int(np.prod(mesh.devices.shape))
    bits_per_iter = ndev * batch_per_dev * block_bits

    def per_device(key):
        idx = jax.lax.axis_index("data")
        key = key[0]                       # this device's own key

        def body(carry):
            key, errs_loc, it, _ = carry
            key, k1, k2 = jax.random.split(key, 3)
            tx = jax.random.bernoulli(
                k1, 0.5, (batch_per_dev, block_bits)).astype(jnp.uint8)
            floats = testsig.modulate_encode(code, tx, True)
            syms = testsig.awgn_quantize(floats, k2, EbNo_dB, code.R, spec)
            rx = _decode_for_ber(spec, path, syms, block_bits,
                                 axis="data")
            errs_loc = errs_loc + testsig.count_bit_errors(rx, tx)
            # one collective per iteration: errors must psum (the global
            # stop depends on them); the global bit count is
            # deterministic, so it is derived, not reduced
            return (key, errs_loc, it + 1,
                    jax.lax.psum(errs_loc, "data"))

        def cond(carry):
            _, _, it, errs_tot = carry
            bits_tot = z + it * bits_per_iter
            return jnp.logical_and(bits_tot < stop_bits,
                                   errs_tot < stop_errors)

        z = jnp.asarray(bits_done0, jnp.int32)
        e = jnp.asarray(errors0, jnp.int32)
        # carried error total resumes from the previous slice; locals
        # restart at a per-device share (device 0 takes the remainder)
        # so the psum reproduces the total exactly
        e_loc = e // ndev + jnp.where(idx == 0, e % ndev, 0)
        _, _, it, errs_tot = jax.lax.while_loop(
            cond, body, (key, e_loc, jnp.int32(0), e))
        return (z + it * bits_per_iter)[None], errs_tot[None]

    # the Pallas interpreter's state discharge drops the varying-axis
    # type of untouched refs, which the vma check rejects
    fn = jax.shard_map(per_device, mesh=mesh,
                       in_specs=(P("data"),), out_specs=P("data"),
                       check_vma=not path.interpret)
    # per-device PRNG streams via split (works for both raw uint32 and
    # new-style typed keys; fold_in on a tiled raw pair would not)
    bits_tot, errs_tot = fn(jax.random.split(key, ndev))
    return bits_tot[0], errs_tot[0]


def _decode_for_ber(spec, path: DecodePath, syms, block_bits, axis=None):
    """Decode one block of frames on ``path``.  ``axis``: the shard_map
    axis name when called inside a mesh shard, so that the fresh
    constants (initial metrics, end states) carry the same varying-axis
    type as the symbols."""

    def v(x):
        return pvary(x, axis) if axis else x

    Bl = syms.shape[0]
    bits, _, _ = path.decode(spec, v(jax_core.initial_metrics(spec, Bl)),
                             syms, v(jnp.zeros(Bl, jnp.int32)), block_bits)
    return bits


def measure_point(code: CodeSpec, config: DecoderConfig, EbNo_dB: float, *,
                  key, block_bits: int = 2048, batch: int = 256,
                  max_bits: int, max_errors: int = 10_000,
                  backend: Union[str, DecodePath] = "auto",
                  timeout_seconds: Optional[float] = None,
                  mesh=None) -> BerPoint:
    """Measure one (code, config, Eb/No) BER point on device.

    ``timeout_seconds`` adds the reference's third per-point stopping
    rule (run_snr_ber.cpp:361-379): the point also ends when its wall
    clock expires.  The device loop then runs in bounded slices (a few
    batches each) with the clock checked between slices; without a
    timeout one device program runs the whole point.

    ``mesh``: a `jax.sharding.Mesh` with a 'data' axis - the point then
    runs data-parallel across the mesh (``batch`` frames *per device*,
    device-folded PRNG streams, psum'd global stopping budgets), the
    mesh analogue of the reference's thread-pool BER tasks.

    ``backend``: the decode path (:func:`.paths.select_path`), chosen for
    the platform of ``mesh`` (default: JAX's default backend).
    """
    import time

    spec = jax_core.make_static_spec(code, config)
    platform = (mesh.devices.flat[0].platform if mesh is not None
                else None)
    path = select_path(spec, platform, backend)

    # The device counters are int32; keep the stop thresholds far enough
    # from INT32_MAX that one more iteration's increment cannot wrap the
    # carry (a wrapped bits_done goes negative and the while_loop runs
    # ~4000x past its budget).  The reference's own budget formula
    # (run_snr_ber.cpp:225-232) tops out well under this cap.
    ndev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    cap = (1 << 31) - 1 - batch * block_bits * ndev
    max_bits = min(int(max_bits), cap)
    max_errors = min(int(max_errors), cap)

    if mesh is not None:
        def run_slice(key, stop_bits, done, errs):
            bits_tot, errs_tot = _point_device_dp(
                spec, code, key, jnp.float32(EbNo_dB), int(block_bits),
                int(batch), path, jnp.int32(stop_bits),
                jnp.int32(max_errors), done, errs, mesh)
            key, _ = jax.random.split(key)
            return key, bits_tot, errs_tot
    else:
        def run_slice(key, stop_bits, done, errs):
            return _point_device(
                spec, code, key, jnp.float32(EbNo_dB), int(block_bits),
                int(batch), path, jnp.int32(stop_bits),
                jnp.int32(max_errors), done, errs)

    if timeout_seconds is None:
        _, bits_done, errors = run_slice(key, max_bits, 0, 0)
    else:
        t0 = time.perf_counter()
        slice_bits = 4 * batch * block_bits * ndev  # a few batches/slice
        bits_done = errors = 0
        while True:
            key, bits_done, errors = run_slice(
                key, min(max_bits, int(bits_done) + slice_bits),
                bits_done, errors)
            bits_done_i, errors_i = int(bits_done), int(errors)
            if (bits_done_i >= max_bits or errors_i >= max_errors
                    or time.perf_counter() - t0 > timeout_seconds):
                break
    bits_done = int(bits_done)
    errors = int(errors)
    return BerPoint(EbNo_dB=float(EbNo_dB),
                    ber=errors / bits_done if bits_done else 0.0,
                    total_bits=bits_done, total_bit_errors=errors)


def measure_point_host_chain(code: CodeSpec, config: DecoderConfig,
                             EbNo_dB: float, *, seed: int = 0,
                             block_bits: int = 2048, batch: int = 256,
                             max_bits: int, max_errors: int = 10_000,
                             timeout_seconds: Optional[float] = None
                             ) -> BerPoint:
    """BER point with the *host* signal chain: the native C++ runtime
    generates data and runs encode -> AWGN -> quantise with mt19937
    noise exactly like the reference harness (run_snr_ber.cpp:317-359),
    and the accelerator only decodes.  This is the closest-possible
    reproduction of the reference measurement pipeline; the default
    :func:`measure_point` keeps the whole loop on device instead.
    """
    from .decoder import ViterbiDecoder
    from .utils import native

    if not native.available():
        raise RuntimeError("native sigchain library unavailable; "
                           "run `make -C native` or native.ensure_built()")
    enc = native.NativeEncoder(code.K, code.G)
    dec = ViterbiDecoder(code, config, traceback_length=block_bits)
    import time

    nbytes = block_bits // 8
    bits_done = 0
    errors = 0
    frame = 0
    t0 = time.perf_counter()
    while bits_done < max_bits and errors < max_errors:
        if (timeout_seconds is not None
                and time.perf_counter() - t0 > timeout_seconds):
            # third stopping rule (run_snr_ber.cpp:361-379)
            break
        data = native.random_bytes(seed * 1_000_003 + frame,
                                   batch * nbytes).reshape(batch, nbytes)
        syms = enc.encode_awgn_quantize(
            data, EbNo_dB, config.soft_decision_high,
            config.soft_decision_low, seed=seed * 7_000_003 + frame)
        out, _, _ = dec.decode(syms.astype(np.int32), block_bits)
        got = np.packbits(np.asarray(out), axis=-1, bitorder="big")
        errors += native.count_bit_errors_bytes(got, data)
        bits_done += batch * block_bits
        frame += batch
    return BerPoint(EbNo_dB=float(EbNo_dB),
                    ber=errors / bits_done if bits_done else 0.0,
                    total_bits=bits_done, total_bit_errors=int(errors))


def sweep(code: CodeSpec, config: DecoderConfig, *, seed: int = 0,
          EbNo_start: float = 0.0, EbNo_step: float = 0.5,
          max_points: int = 24, block_bits: int = 2048, batch: int = 256,
          max_bits: Optional[int] = None, max_errors: int = 10_000,
          bits_scale: float = 1.0,
          backend: Union[str, DecodePath] = "auto",
          host_chain: bool = False,
          timeout_seconds: Optional[float] = None,
          mesh=None) -> SweepResult:
    """Eb/No sweep, stopping at the first zero-error point
    (run_snr_ber.cpp:318-396).  ``host_chain`` generates the channel on
    the native C++ runtime instead of on device; ``timeout_seconds``
    bounds each point's wall clock (the -T stopping rule); ``mesh``
    runs every point data-parallel over the mesh's 'data' axis (see
    :func:`measure_point`)."""
    if max_bits is None:
        max_bits = default_max_bits(code, bits_scale)
    if mesh is not None and host_chain:
        raise ValueError("mesh (data-parallel points) and host_chain are "
                         "mutually exclusive: the host chain generates "
                         "the channel on this process's CPU")
    key = jax.random.PRNGKey(seed)
    points = []
    for i in range(max_points):
        key, sub = jax.random.split(key)
        EbNo = EbNo_start + i * EbNo_step
        if host_chain:
            p = measure_point_host_chain(
                code, config, EbNo, seed=seed + i, block_bits=block_bits,
                batch=batch, max_bits=max_bits, max_errors=max_errors,
                timeout_seconds=timeout_seconds)
        else:
            p = measure_point(code, config, EbNo,
                              key=sub, block_bits=block_bits, batch=batch,
                              max_bits=max_bits, max_errors=max_errors,
                              backend=backend,
                              timeout_seconds=timeout_seconds, mesh=mesh)
        points.append(p)
        if p.total_bit_errors == 0:
            break
    return SweepResult(code=code, points=points)
