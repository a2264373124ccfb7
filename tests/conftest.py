"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

This is the multi-device-without-a-cluster strategy from SURVEY.md §4:
all sharding tests run against `--xla_force_host_platform_device_count=8`.
The platform is pinned to the CPU through jax.config before any backend
is initialized, so every test worker stays off the GPU; the GPU path is
checked by `chip_smoke.py`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


# jaxlib 0.9 CPU segfaults nondeterministically once a single process
# accumulates ~100+ compiled executables (observed inside
# backend_compile_and_load and the cache serializer on this host, always
# past ~70% of a cold full-suite run). Bound the number of live
# executables by dropping JAX's in-memory caches between test modules;
# the persistent on-disk compilation cache (.jax_cache) makes any
# re-encounter a cheap deserialize instead of a recompile.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()
