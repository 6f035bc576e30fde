"""What a measurement ran on: JAX's view of the device plus the card's
name and power limit as nvidia-smi reports them."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """`name, power.limit` of each visible card, one per line (nvidia-smi's
    own text), or a note saying why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc {out.returncode})"
    return out.stdout.strip()


def describe() -> dict:
    """{"platform", "kind", "count", "card"} for the default backend."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_line()}


def require_gpu() -> dict:
    """describe(), raising when JAX found no GPU: a measurement never falls
    back to the CPU."""
    info = describe()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {info['platform']} "
            f"({info['kind']})")
    return info
