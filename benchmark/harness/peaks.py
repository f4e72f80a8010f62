"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit). A card not listed
has no peaks, and the shares of a peak are then left out."""

PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``)."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None
