"""The accelerator a measurement runs on, for scripts that must not run
anywhere else (bench.py, chip_smoke.py)."""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return jax's first device; raise SystemExit when it is not a GPU (a
    timing or a chip check taken on the CPU is not a device number)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: jax's default device is {dev.platform} "
                         f"({dev.device_kind}); refusing to run")
    return dev


def card_name_and_power() -> str:
    """The card's name and power limit as nvidia-smi reports them, one line
    per card. A card set below its maximum power runs slower under load, so
    every time is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
