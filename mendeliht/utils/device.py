"""What the device reports about itself."""

from __future__ import annotations

import jax


def memory_limit_bytes(device=None) -> int | None:
    """Bytes the device's allocator may hand out (``memory_stats()
    ["bytes_limit"]``), or None where the backend reports none — the CPU
    backend, whose arrays live in host memory."""
    device = jax.devices()[0] if device is None else device
    stats = device.memory_stats()
    return None if not stats else stats.get("bytes_limit")
