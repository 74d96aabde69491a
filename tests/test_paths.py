"""The one routing function (paths.select_path) and the kernel wrapper's
frame blocking and padding."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from viterbidecodercpp_jax import (COMMON_CODES, CodeSpec, DecodeType,
                                   StreamingDecoder, ViterbiDecoder,
                                   get_code, get_decode_config)
from viterbidecodercpp_jax import paths
from viterbidecodercpp_jax.decoder import DecoderState
from viterbidecodercpp_jax.ops import jax_core, triton_kernels as tk


def spec_of(code, decode_type=DecodeType.SOFT8):
    return jax_core.make_static_spec(
        code, get_decode_config(decode_type, code.R))


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("code", COMMON_CODES, ids=lambda c: c.name)
def test_auto_path_per_platform(code, platform):
    spec = spec_of(code)
    path = paths.select_path(spec, platform)
    in_range = (paths.KERNEL_MIN_STATES <= spec.S
                <= paths.KERNEL_MAX_STATES)
    want = "pallas" if platform == "gpu" and in_range else "xla"
    assert path.backend == want and not path.interpret
    assert paths.select_path(spec, platform, "xla").backend == "xla"


def test_admission_range_edges_on_gpu():
    """Custom codes at the edges of the admission range: K=13 (S=4096)
    takes the kernels, K=14 (S=8192) and K=2 (S=2) take XLA."""
    k13 = CodeSpec("K13", 13, (0o17661, 0o11457))
    k14 = CodeSpec("K14", 14, (0o25621, 0o33527))
    k2 = CodeSpec("K2", 2, (0b11, 0b11))
    assert paths.select_path(spec_of(k13), "gpu").backend == "pallas"
    assert paths.select_path(spec_of(k14), "gpu").backend == "xla"
    assert paths.select_path(spec_of(k2), "gpu").backend == "xla"
    assert paths.select_path(spec_of(get_code("Cassini")), "gpu").backend \
        == "xla"


def test_explicit_pallas_raises_where_it_cannot_run():
    voyager = spec_of(get_code("Voyager"))
    cassini = spec_of(get_code("Cassini"))
    with pytest.raises(ValueError, match="compiles for the 'gpu'"):
        paths.select_path(voyager, "cpu", "pallas")
    with pytest.raises(ValueError, match="S=16384"):
        paths.select_path(cassini, "gpu", "pallas")
    with pytest.raises(ValueError, match="S=16384"):
        paths.select_path(cassini, "cpu", "pallas", interpret=True)
    with pytest.raises(ValueError, match="unknown backend"):
        paths.select_path(voyager, "gpu", "mosaic")
    # the constructors route through the same function
    with pytest.raises(ValueError):
        ViterbiDecoder(get_code("Voyager"), "SOFT8", backend="pallas")
    with pytest.raises(ValueError):
        StreamingDecoder(get_code("Voyager"), "SOFT8", window=8, chunk=4,
                         backend="pallas")


def test_interpret_is_only_ever_explicit():
    voyager = spec_of(get_code("Voyager"))
    for fn in (tk.acs, tk.walk, paths.select_path):
        assert inspect.signature(fn).parameters["interpret"].default is False
    assert paths.DecodePath("pallas").interpret is False
    # auto never interprets, whatever is asked
    assert not paths.select_path(voyager, "cpu", interpret=True).interpret
    p = paths.select_path(voyager, "cpu", "pallas", interpret=True)
    assert p.backend == "pallas" and p.interpret
    # a path passes through unchanged
    assert paths.select_path(voyager, "gpu", p) is p


@pytest.mark.parametrize("S,B,want", [
    (4, 512, 32), (16, 512, 32), (64, 512, 16), (256, 512, 4),
    (64, 3, 4), (64, 1, 1), (256, 2, 2), (16384, 8, 1), (4096, 512, 1),
])
def test_frames_per_program(S, B, want):
    got = tk.frames_per_program(S, B)
    assert got == want and got & (got - 1) == 0


@pytest.mark.parametrize("B", [1, 6, 17])
def test_kernel_wrapper_pads_ragged_batches(B):
    """Batches that are not a whole number of programs pad and crop:
    results equal the XLA path frame for frame."""
    spec = spec_of(get_code("Basic K=5 R=1/2"), DecodeType.SOFT16)
    rng = np.random.RandomState(B)
    syms = jnp.asarray(rng.randint(-127, 128, (B, 12, 2)).astype(np.int32))
    m0 = jax_core.initial_metrics(spec, B)
    want = jax_core.acs_scan(spec, m0, syms)
    got = tk.acs(spec, m0, syms, interpret=True)
    for x, y in zip(want, got):
        assert x.shape == y.shape
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    ends = jnp.asarray(rng.randint(0, spec.S, B).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(jax_core.chainback_scan(spec, want[1], ends, 8)),
        np.asarray(tk.walk(spec, want[1], ends, spec.K - 1, 8,
                           interpret=True)))


def test_walk_rejects_rows_past_the_buffer():
    spec = spec_of(get_code("Voyager"))
    packed = jnp.zeros((10, spec.W, 2), jnp.int32)
    with pytest.raises(ValueError, match="rows"):
        tk.walk(spec, packed, jnp.zeros(2, jnp.int32), 6, 5, interpret=True)


def test_decoder_chunked_update_on_interpreted_kernels():
    """ViterbiDecoder given the kernel path: reset -> chunked update ->
    chainback equals the XLA decoder's one-shot decode."""
    code = get_code("LTE")
    config = get_decode_config(DecodeType.HARD8, code.R)
    spec = spec_of(code, DecodeType.HARD8)
    kern = ViterbiDecoder(code, config, traceback_length=40,
                          backend=paths.select_path(spec, "cpu", "pallas",
                                                    interpret=True))
    xla = ViterbiDecoder(code, config, traceback_length=40, backend="xla")
    rng = np.random.RandomState(2)
    syms = rng.randint(0, 256, (4, (40 + code.K - 1) * code.R)).astype(
        np.int32)
    state = kern.reset(4)
    for lo, hi in ((0, 7), (7, 30), (30, 46)):
        state = kern.update(state, syms[:, lo * code.R:hi * code.R])
    bits_k = kern.chainback(state, 40)
    bits_x, err_x, acc_x = xla.decode(syms, 40)
    np.testing.assert_array_equal(np.asarray(bits_k), np.asarray(bits_x))
    np.testing.assert_array_equal(np.asarray(kern.get_error(state)),
                                  np.asarray(err_x))
    np.testing.assert_array_equal(np.asarray(state.accumulated_error),
                                  np.asarray(acc_x))
    np.testing.assert_array_equal(
        np.asarray(kern.decode(syms, 40)[0]), np.asarray(bits_x))


def test_load_rejects_slot_order_checkpoints(tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez(path, metrics=np.zeros((64, 1), np.int32),
             decisions=np.zeros((8, 2, 1), np.int32),
             accumulated_error=np.zeros(1, np.int32),
             bit_cursor=np.zeros((), np.int32),
             row_rots=np.zeros(8, np.int32))
    with pytest.raises(ValueError, match="row_rots"):
        DecoderState.load(path)


@pytest.mark.parametrize("mesh_kind", ["data", "time"])
def test_compiled_kernel_path_traces_under_shard_map(mesh_kind, mesh_of):
    """The compiled (not interpreted) kernel path type-checks inside
    shard_map with the varying-axes check on: frame-DP runs both kernels,
    time-SP the ACS kernel.  Tracing only - no GPU needed."""
    import jax
    from jax.sharding import PartitionSpec as P

    from viterbidecodercpp_jax.parallel.mesh import pvary

    spec = spec_of(get_code("Voyager"))
    path = paths.DecodePath("pallas")
    mesh = mesh_of((4,), (mesh_kind,))

    def shard_fn(syms):
        Bl = syms.shape[0]
        m0 = pvary(jax_core.initial_metrics(spec, Bl), mesh_kind)
        if mesh_kind == "time":
            return path.update(spec, m0, syms)[1]
        bits, _, _ = path.decode(spec, m0, syms,
                                 pvary(jnp.zeros(Bl, jnp.int32), "data"), 32)
        return bits

    spec_in = P("data") if mesh_kind == "data" else P(None, "time")
    spec_out = P("data") if mesh_kind == "data" else P("time")
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec_in,),
                       out_specs=spec_out, check_vma=True)
    jaxpr = jax.jit(fn).trace(jnp.zeros((8, 40, 2), jnp.int32)).jaxpr
    assert "pallas_call" in str(jaxpr)
