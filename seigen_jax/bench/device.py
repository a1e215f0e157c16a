"""What every device measurement prints beside its numbers."""

from __future__ import annotations

import subprocess


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the card, or a reason."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def require_gpu(what: str):
    """The first JAX device, or SystemExit when it is not a GPU: a device
    measurement does not fall back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"{what}: no GPU found (JAX platform "
                         f"{dev.platform!r})")
    return dev
