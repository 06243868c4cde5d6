"""Process and device memory usage reporting.

Capability parity with ``CProcessMemInfo::n_MemoryUsage``
(include/slam/MemUsage.h:54,76) plus per-device memory stats from the JAX
runtime.
"""

from __future__ import annotations

from typing import Dict, Optional


def process_memory_usage() -> int:
    """Resident set size in bytes (host)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


def peak_memory_usage() -> int:
    """Peak resident set size in bytes (host)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


def device_memory_stats(device=None) -> Optional[Dict]:
    """Memory usage of a JAX device, if the backend exposes it."""
    import jax

    d = device or jax.devices()[0]
    try:
        return d.memory_stats()
    except Exception:
        return None


def format_memory_report() -> str:
    rss = process_memory_usage() / 1048576.0
    peak = peak_memory_usage() / 1048576.0
    out = [f"host RSS: {rss:.1f} MB (peak {peak:.1f} MB)"]
    stats = device_memory_stats()
    if stats:
        used = stats.get("bytes_in_use", 0) / 1048576.0
        limit = stats.get("bytes_limit", 0) / 1048576.0
        out.append(f"device memory: {used:.1f} / {limit:.1f} MB")
    return "; ".join(out)
