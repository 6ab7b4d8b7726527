"""Which device a measurement ran on.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
``require_gpu`` and refuse to report a number from any other platform, and
print ``card_info`` beside every time they report: a card set below its
power limit runs slower under load.
"""

from __future__ import annotations

import subprocess
from typing import List


def require_gpu(devices) -> None:
    """Raise unless JAX's default device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU: JAX's default device is {kind}")


def card_info() -> List[str]:
    """``nvidia-smi`` name and power limit, one entry per card. Not a JAX
    process, so it does not contend for the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable ({type(e).__name__})"]
    return [line.strip() for line in out.splitlines() if line.strip()]
