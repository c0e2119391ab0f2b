"""The card a measurement runs on: require it, and name it.

Every number a measurement prints names the device it ran on.  A
measurement path that finds no GPU fails; it never falls back to the CPU.
"""
from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's devices; raises RuntimeError unless the default backend is a
    GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU, but JAX's default backend is "
            f"{devs[0].platform!r} ({len(devs)} device(s))")
    return devs


def device_info(devs) -> dict:
    """platform, device_kind and count, as JAX reports them."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_power() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W")."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()
