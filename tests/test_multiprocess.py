"""Multi-process integration test: 2 spawned processes, gloo collectives.

The framework's multi-host path (parallel/launch.py) is exercised the
way real 2-host hardware would run it: two OS processes each hosting 2
virtual CPU devices join one distributed JAX run and decode with

  * frame-DP over all 4 devices (scalar psum crossing the process
    boundary),
  * time-SP with the stream's time axis spanning the two processes
    (halo ppermute over the inter-process link), and
  * the composed 2-D mesh (data across processes x time within each).

This is the CPU stand-in for a real multi-host fleet (the analogue of
the reference CI running its NEON build under qemu, SURVEY.md
section 4).  Workers assert exact decodes; any failure propagates as a
nonzero exit.
"""

import pytest

from viterbidecodercpp_jax.parallel import launch


def test_two_process_dryrun():
    # launch_processes enforces its own per-worker timeout
    launch.launch_processes(2, 2, timeout=540)


def test_spawn_fleet_failure_paths():
    """spawn_fleet surfaces worker failures with their output, and
    enforces the success token."""
    import sys

    ok = [sys.executable, "-c", "print('TOKEN ok')"]
    bad = [sys.executable, "-c", "print('boom'); raise SystemExit(3)"]

    outs = launch.spawn_fleet(lambda pid, port: ok, 2,
                              success_token="TOKEN")
    assert len(outs) == 2 and all("TOKEN" in o for o in outs)

    with pytest.raises(RuntimeError, match="boom"):
        launch.spawn_fleet(lambda pid, port: bad, 1)

    with pytest.raises(RuntimeError, match="success"):
        launch.spawn_fleet(lambda pid, port: ok, 1,
                           success_token="ABSENT")


def test_hybrid_mesh_single_process(need_devices):
    """make_hybrid_mesh on the in-process (virtual 8-device) fleet:
    across-host axes outer, sizes must cover every device."""
    import jax

    need_devices(2)
    n = jax.device_count()
    mesh = launch.make_hybrid_mesh(dcn={"data": 2}, ici={"time": n // 2})
    assert mesh.axis_names == ("data", "time")
    assert mesh.shape["data"] == 2 and mesh.shape["time"] == n // 2

    with pytest.raises(ValueError):
        launch.make_hybrid_mesh(dcn={"data": 3}, ici={"time": n})
    with pytest.raises(ValueError):
        launch.make_hybrid_mesh()
