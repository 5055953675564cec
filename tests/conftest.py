"""Test configuration.

JAX runs on the CPU with a virtual 8-device mesh, so multi-device sharding
logic is exercised without accelerators (SURVEY.md §4: the
--xla_force_host_platform_device_count simulation).  JAX_PLATFORMS is
honoured when it is set: the GPU tests (marker ``gpu``) run on a machine
with a card as ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
Whether a card is present is decided by the ``gpu`` fixture at run time,
never while a module is imported.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU: run `pytest -m gpu` on the card")
    return devs[0]
