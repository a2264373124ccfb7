"""The accelerator a measurement runs on.

`bench.py`, `chip_smoke.py` and `tools/profile_stages.py` time or check
the GPU path, so they start with `require_gpu()`: a run that finds no
GPU stops with a non-zero exit instead of measuring the CPU backend.
The library itself never picks a platform.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu(min_count: int = 1) -> list:
    """Return `jax.devices()` if JAX's default backend is a GPU with at
    least `min_count` devices; exit with an error otherwise."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {devs[0].platform!r}")
    if len(devs) < min_count:
        raise SystemExit(f"need {min_count} GPUs, JAX sees {len(devs)}")
    return devs


def card_lines() -> list[str]:
    """`name, power.limit` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
