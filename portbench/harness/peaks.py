"""Published dense peaks of the cards the benchmark may run on (NVIDIA's
data sheets, at the full power limit), by the name the card reports; most
specific names first. Values: (float32 non-tensor FLOP/s, bf16 tensor
FLOP/s, memory bytes/s)."""
from __future__ import annotations

PEAKS = {"H100 PCIe": (51e12, 756e12, 2.0e12),
         "H100 NVL": (60e12, 835e12, 3.9e12),
         "H100": (67e12, 989e12, 3.35e12)}


def peaks_for(name: str):
    """{'fp32', 'bf16', 'bytes'} of a card name, or None for a card the
    table does not know (a share of its peak is then not reported)."""
    for key, (f32, bf16, bw) in PEAKS.items():
        if key in name:
            return {"card": key, "fp32": f32, "bf16": bf16, "bytes": bw}
    return None
