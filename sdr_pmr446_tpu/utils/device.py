"""What a measurement ran on: JAX's device record and the card's identity.

Every result line of the benchmarks and of ``chip_smoke.py`` carries both,
so that no number is read without its device.  A card may be set below
its maximum power and then runs slower under load, so the power limit is
part of the record.
"""

from __future__ import annotations

import subprocess


def device_record() -> dict:
    """{"platform", "kind", "count"} as JAX reports the attached devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_identity() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one card per ``;``-separated entry, or a note that it is unavailable
    (a CPU rehearsal)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(ln.strip() for ln in r.stdout.splitlines()
                     if ln.strip())
