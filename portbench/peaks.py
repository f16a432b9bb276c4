"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, at the full power limit of 700 W)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind):
    """The card's memory bandwidth, or None for a device not in the table."""
    return PEAKS.get(kind, {}).get("hbm_bytes_per_s")
