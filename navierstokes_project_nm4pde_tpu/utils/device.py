"""Which device a measurement ran on.

Every device number this repository prints is stamped with the device JAX
reports and, on NVIDIA cards, the name and power limit `nvidia-smi` reads
(a card set below its maximum power runs slower under load).  A
measurement path that finds no GPU fails instead of falling back to the
CPU.
"""

from __future__ import annotations

import shutil
import subprocess

SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def device_info() -> dict:
    """{"platform", "kind", "count"} of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """device_info(), or RuntimeError when JAX's default backend is not a
    GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on the card"
        )
    return info


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output, one card per line (stripped); "not available" without the
    tool."""
    if shutil.which(SMI_QUERY[0]) is None:
        return "nvidia-smi: not available"
    out = subprocess.run(
        SMI_QUERY, capture_output=True, text=True, timeout=30, check=False
    )
    if out.returncode != 0:
        return f"nvidia-smi: failed ({out.stderr.strip()[:200]})"
    return "\n".join(ln.strip() for ln in out.stdout.strip().splitlines())
