"""Test configuration.

On a host without a GPU the suite runs on 8 virtual CPU devices, so the
mesh tests get a mesh (the analogue of the reference CI running its NEON
build under qemu, SURVEY.md section 4).  Tests marked ``gpu`` need an
NVIDIA GPU and skip elsewhere; on the card, run them with
``python -m pytest tests/ -m gpu``.
"""

import math
import os

import pytest

# Sizes the host platform only; set before JAX starts any backend.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture(autouse=True)
def _gpu_gate(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card with -m gpu)")


@pytest.fixture
def need_devices():
    """``need_devices(n)`` skips the test unless JAX has n devices."""
    import jax

    def need(n):
        if len(jax.devices()) < n:
            pytest.skip(f"needs {n} devices, have {len(jax.devices())}")

    return need


@pytest.fixture
def mesh_of(need_devices):
    """``mesh_of(sizes, names)``: a mesh over the first prod(sizes)
    devices, skipping the test when there are fewer."""
    from viterbidecodercpp_jax.parallel.mesh import make_mesh

    def make(sizes, names):
        need_devices(math.prod(sizes))
        return make_mesh(sizes, names)

    return make
