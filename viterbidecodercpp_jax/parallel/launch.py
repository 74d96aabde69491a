"""Multi-process / multi-host execution scaffolding.

The reference is strictly single-process (SURVEY.md section 2.4: a
thread pool over shared memory is its only parallelism).  This framework
scales past one process with the standard JAX SPMD recipe:
``jax.distributed.initialize`` per process, one *global* mesh spanning
every device of every process, ``shard_map`` programs written against
mesh axis names (frame_dp.py / block_sp.py - unchanged), and global
arrays assembled from per-process local shards.

:func:`make_hybrid_mesh` names its two device groups after where their
collectives travel: ``dcn`` axes go *across hosts* (the outer, host-major
dimension) and ``ici`` axes stay *within a host*.  Axis placement policy
for this workload:

  * ``data`` (frame-DP) goes across hosts: frames are independent and
    the only cross-shard traffic is a scalar ``psum`` of statistics - the
    cheapest thing a slow link can carry.
  * ``time`` (block-SP) stays within a host: halo exchange ships
    overlap-sized symbol/decision slabs between *neighbouring* tiles
    (`lax.ppermute`).  With time inner and host-major device order, only
    1 of the ntime-1 tile boundaries crosses hosts even when a single
    stream spans hosts.

The 2-process CPU integration test (tests/test_multiprocess.py)
exercises frame-DP across processes, time-SP across processes, and the
composed 2-D mesh end-to-end with gloo collectives.

One process per card: ``--platform native`` gives worker ``i`` card
``i`` of its host alone (``local_device_ids``), since a JAX process
reserves most of the memory of every card it opens.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["initialize", "make_hybrid_mesh", "global_array",
           "process_count", "process_index", "is_coordinator",
           "dryrun_worker"]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *,
               local_device_count: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               platform: Optional[str] = None) -> None:
    """Join this process to a distributed JAX run.

    Must be called before any JAX backend initialises.  ``platform="cpu"``
    simulates a multi-host fleet on one machine: each process hosts
    ``local_device_count`` virtual CPU devices and cross-process
    collectives run over gloo - the CI stand-in for a real multi-host
    fleet (the analogue of the reference running its NEON build under
    qemu, SURVEY.md section 4).  ``platform=None`` uses the default
    backend; ``local_device_ids`` then restricts this process to those
    cards of its host.
    """
    if platform == "cpu":
        if local_device_count:
            flags = os.environ.get("XLA_FLAGS", "")
            want = f"--xla_force_host_platform_device_count={local_device_count}"
            if "xla_force_host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (flags + " " + want).strip()
        os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")

    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def process_count() -> int:
    import jax
    return jax.process_count()


def process_index() -> int:
    import jax
    return jax.process_index()


def is_coordinator() -> bool:
    return process_index() == 0


def _devices_host_major():
    """All global devices, ordered host-major (process index outer, local
    order inner) so reshapes put the host dimension outermost."""
    import jax
    return sorted(jax.devices(), key=lambda d: (d.process_index, d.id))


def make_hybrid_mesh(dcn: Optional[Dict[str, int]] = None,
                     ici: Optional[Dict[str, int]] = None):
    """Build a global Mesh with ``dcn`` (across-host) axes outer and
    ``ici`` (within-host) axes inner.

    ``dcn`` maps axis names to sizes whose product must equal the process
    count; ``ici`` likewise for the per-process local device count.
    Either may be omitted (size-1 hosts / a purely local mesh).  When an
    axis must span *both* hosts and local devices (e.g. one 'data' axis
    over every chip in a 2-host fleet), give it in ``dcn`` with the full
    size and leave ``ici`` empty - host-major device order makes each
    process's block contiguous, so per-process shards stay addressable.

    Examples::

        # frame-DP over every chip of every host
        make_hybrid_mesh(dcn={"data": jax.device_count()})
        # frames across hosts (one scalar psum), one stream's time axis
        # across each host's cards (halo ppermute)
        make_hybrid_mesh(dcn={"data": 2}, ici={"time": 4})
    """
    from jax.sharding import Mesh

    dcn = dict(dcn or {})
    ici = dict(ici or {})
    if not dcn and not ici:
        raise ValueError("give at least one mesh axis")
    devices = _devices_host_major()
    sizes = tuple(dcn.values()) + tuple(ici.values())
    names = tuple(dcn.keys()) + tuple(ici.keys())
    n = int(np.prod(sizes))
    if n != len(devices):
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need {n} devices, "
            f"have {len(devices)} "
            f"({process_count()} processes x local devices)")
    arr = np.array(devices).reshape(*sizes)
    return Mesh(arr, names)


def global_array(mesh, pspec, local_data):
    """Assemble a global jax.Array from this process's shard.

    ``local_data`` is the block of the global array owned by this
    process under ``NamedSharding(mesh, pspec)`` (host-major order: for
    an axis of global size G over P processes, process p supplies rows
    [p*G/P, (p+1)*G/P)).  In single-process runs this is just
    device_put with the sharding.
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, pspec)
    if process_count() == 1:
        return jax.device_put(local_data, sharding)
    # host-major meshes shard every named axis across processes in
    # contiguous blocks, which is exactly the local-block convention
    # make_array_from_process_local_data infers the global shape from
    return jax.make_array_from_process_local_data(sharding, local_data)


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# Worker + launcher for the 2-process integration check
# ---------------------------------------------------------------------------

def dryrun_worker(coordinator_address: str, num_processes: int,
                  process_id: int, local_devices: int,
                  platform: Optional[str] = "cpu",
                  local_device_ids: Optional[Sequence[int]] = None) -> None:
    """One process of the multi-process dryrun.

    Joins the distributed run, then exercises every cross-process
    pattern the framework uses:

      1. frame-DP with 'data' spanning all devices of all processes
         (scalar psum across processes) - exact decode required;
      2. time-SP with 'time' spanning processes (halo ppermute across
         them);
      3. the composed 2-D mesh: 'data' across processes x 'time' within
         each.

    Prints ``MULTIPROCESS OK`` on success (coordinator only).
    """
    initialize(coordinator_address, num_processes, process_id,
               local_device_count=local_devices,
               local_device_ids=local_device_ids, platform=platform)

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..codes import get_code
    from ..config import DecodeType, get_decode_config
    from ..ops import jax_core, numpy_ref
    from . import block_sp, frame_dp

    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = jax_core.make_static_spec(code, config)
    ndev = jax.device_count()
    assert ndev == num_processes * local_devices

    # --- 1. frame-DP across every device of every process ----------------
    mesh = make_hybrid_mesh(dcn={"data": ndev})
    rng = np.random.RandomState(0)
    B, nbytes = 2 * ndev, 8
    data = rng.randint(0, 256, (B, nbytes), dtype=np.uint8)
    syms = np.stack([
        numpy_ref.encode_bytes(code, d, config.soft_decision_high,
                               config.soft_decision_low) for d in data
    ])
    T = syms.shape[1] // code.R
    total_bits = nbytes * 8
    ref_bits = np.unpackbits(data, axis=1, bitorder="big")
    lo, hi = process_id * B // num_processes, (process_id + 1) * B // num_processes
    sym_g = global_array(mesh, P("data", None, None),
                         syms.reshape(B, T, code.R)[lo:hi].astype(np.int32))
    ref_g = global_array(mesh, P("data", None), ref_bits[lo:hi])
    _, errs = frame_dp.decode_dp(spec, mesh, sym_g, total_bits,
                                 reference_bits=ref_g)
    assert int(errs) == 0, f"frame-DP: {int(errs)} bit errors"

    # --- 1b. mesh-BER point across the fleet: the while-loop's psum'd
    # stopping budgets cross the process boundary every iteration ------
    from .. import ber
    p = ber.measure_point(code, config, 4.0, key=jax.random.PRNGKey(0),
                          block_bits=128, batch=2,
                          max_bits=ndev * 2 * 128, max_errors=10**6,
                          mesh=mesh)
    assert p.total_bits >= ndev * 2 * 128, p

    # --- 2. time-SP with the stream's time axis across hosts ------------
    def run_sp(mesh_sp, data_axis_size):
        ntime = mesh_sp.shape["time"]
        nb = 16 * ntime
        Bs = data_axis_size
        d2 = rng.randint(0, 256, (Bs, nb), dtype=np.uint8)
        s2 = np.stack([
            numpy_ref.encode_bytes(code, d, config.soft_decision_high,
                                   config.soft_decision_low) for d in d2
        ])
        bits2 = nb * 8
        T2 = bits2 + code.K - 1
        pad = -(-T2 // ntime) * ntime
        arr = np.zeros((Bs, pad, code.R), np.int32)
        arr[:, :T2] = s2.reshape(Bs, T2, code.R)
        has_data = "data" in mesh_sp.shape
        pspec = P("data" if has_data else None, "time", None)
        # local block along each sharded input axis (host-major layout)
        loc = _local_block(arr, mesh_sp, ("data" if has_data else None,
                                          "time", None), process_id)
        sym_g2 = global_array(mesh_sp, pspec, loc)
        out, mism = block_sp.decode_stream_sp(spec, mesh_sp, sym_g2,
                                              overlap=64, total_rows=T2)
        assert int(mism) == 0, "halo diagnostic reported mismatches"
        # replicate the result for the check (an all-gather over the mesh)
        rep = jax.jit(lambda x: x,
                      out_shardings=NamedSharding(mesh_sp, P()))(out)
        got = np.asarray(rep)[:, code.K - 1:code.K - 1 + bits2]
        expect = np.unpackbits(d2, axis=1, bitorder="big")
        nerr = int((got != expect).sum())
        assert nerr == 0, f"time-SP ({dict(mesh_sp.shape)}): {nerr} errors"

    # time spans processes: the halo exchange crosses them
    run_sp(make_hybrid_mesh(dcn={"time": num_processes},
                            ici={"data": local_devices}),
           local_devices)
    # composed 2-D: data across processes, time within each
    if local_devices >= 2:
        run_sp(make_hybrid_mesh(dcn={"data": num_processes},
                                ici={"time": local_devices}),
               num_processes)

    if process_id == 0:
        print("MULTIPROCESS OK", flush=True)
    jax.distributed.shutdown()


def _local_block(arr: np.ndarray, mesh, axes: Sequence[Optional[str]],
                 process_id: int):
    """This process's contiguous block of ``arr`` under a host-major
    NamedSharding over ``axes`` (axis name or None per array dim)."""
    out = arr
    for dim, name in enumerate(axes):
        if name is None:
            continue
        axis = list(mesh.axis_names).index(name)
        size = mesh.shape[name]
        # index of this process's first block along the mesh axis
        dev = np.moveaxis(mesh.devices, axis, 0)
        owned = sorted({i for i in range(size)
                        if any(d.process_index == process_id
                               for d in dev[i].flat)})
        if len(owned) == size:   # axis fully local to every process
            continue
        blk = arr.shape[dim] // size
        lo, hi = owned[0] * blk, (owned[-1] + 1) * blk
        out = np.take(out, np.arange(lo, hi), axis=dim)
        arr = out
    return out


def spawn_fleet(make_cmd, num_processes: int, *, timeout: float = 600.0,
                success_token: Optional[str] = None) -> list:
    """Spawn one local worker process per rank against a fresh
    coordinator port and wait for all of them; raises on any failure.

    ``make_cmd(pid, port)`` returns the argv for rank ``pid``.
    ``XLA_FLAGS`` is stripped from the children's environment so each
    sizes its own virtual fleet.  Output is captured and included in
    failure messages; ``success_token``, when given, must appear in at
    least one worker's output.  Returns the per-rank outputs."""
    import subprocess

    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # children size their own virtual fleet
    procs = [subprocess.Popen(make_cmd(pid, port), env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(num_processes)]
    outs = []
    fail = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            fail.append(pid)
        outs.append(out or "")
        if p.returncode != 0:
            fail.append(pid)
    if fail:
        raise RuntimeError(
            f"worker process(es) {sorted(set(fail))} failed:\n"
            + "\n".join(outs))
    if success_token is not None and not any(success_token in o
                                             for o in outs):
        raise RuntimeError("no worker reported success:\n"
                           + "\n".join(outs))
    return outs


def launch_processes(num_processes: int, local_devices: int, *,
                     timeout: float = 600.0) -> None:
    """Spawn ``num_processes`` dryrun workers on this machine (CPU
    simulation) and wait for all of them; raises on any failure."""
    import sys

    def cmd(pid, port):
        return [sys.executable, "-m",
                "viterbidecodercpp_jax.parallel.launch",
                "--coordinator", f"localhost:{port}",
                "--num-processes", str(num_processes),
                "--process-id", str(pid),
                "--local-devices", str(local_devices)]

    spawn_fleet(cmd, num_processes, timeout=timeout,
                success_token="MULTIPROCESS OK")


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--platform", default="cpu",
                    help="'cpu' = simulated fleet; 'native' = default "
                         "backend, worker i on card i of this host "
                         "alone (use --local-devices 1)")
    args = ap.parse_args(argv)
    if args.platform == "native":
        dryrun_worker(args.coordinator, args.num_processes,
                      args.process_id, args.local_devices, platform=None,
                      local_device_ids=[args.process_id])
    else:
        dryrun_worker(args.coordinator, args.num_processes,
                      args.process_id, args.local_devices,
                      platform=args.platform)


if __name__ == "__main__":
    _main()
