"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit; a card set
lower runs slower under load and its ``power.limit`` is printed beside
every run)."""

from __future__ import annotations

H100_SXM = {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def of(device_kind: str | None) -> dict | None:
    """The card's peaks, or None for a device with no entry (the CPU)."""
    return PEAKS.get(device_kind or "")
