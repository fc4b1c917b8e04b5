"""Test config: run JAX on a virtual 8-device CPU mesh by default.

Multi-card hardware is not available in CI; sharding tests use
``xla_force_host_platform_device_count`` (the standard pattern for
developing multi-device code on one machine). ``JAX_PLATFORMS`` picks the
backend (``cpu`` when unset). Tests that need a GPU carry the ``gpu``
marker and skip, with a reason, when the process has none; run them on a
GPU host with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's first device is a GPU.

    Decided here, at run time, so every xdist worker collects the same
    tests whatever the backend."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU (JAX_PLATFORMS=cuda on a GPU host)")


# ---- trace-time knob hygiene -------------------------------------------
#
# Safe mode is a module global consulted at TRACE time; a test that flips
# it and fails before its `finally` would silently run the REST of the
# suite under non-default routing. This autouse session fixture asserts
# at teardown that it is back at its shipped default — a leak fails the
# run loudly.


@pytest.fixture(autouse=True, scope="session")
def _knob_leak_guard():
    yield
    from radio_mapper_tpu.ops import safe

    leaks = {
        name: val
        for name, val, want in (
            ("safe._MODE", safe._MODE, None),
            ("safe._SLIDING_IMPL", safe._SLIDING_IMPL, "window"),
        )
        if val != want
    }
    assert not leaks, f"tests leaked non-default trace-time knobs: {leaks}"
