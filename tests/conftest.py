"""Test configuration: an 8-device virtual CPU mesh by default.

SURVEY.md §4.5 — the suite runs on the CPU with
``--xla_force_host_platform_device_count=8`` so meshes, psum, sharded
resampling, and chain sharding are exercised without accelerators.  A
caller that sets ``JAX_PLATFORMS`` keeps it: ``JAX_PLATFORMS=cuda pytest -m
gpu`` runs the card-only tests on the GPU.  Must run before jax is imported
anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()} ({jax.default_backend()})"
