"""The card's published peaks and the bound rule, frozen here so that no
change to the program can move them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 and 34
TFLOP/s in float64 outside the tensor cores. A card set below 700 W runs
slower under load: every share is printed beside the card's power limit.

The bound of a kernel call is the least time the card could take: its
bytes, each input byte read once and each output byte written once, over
the bandwidth, or its operations over the peak rate of its type, the
larger of the two. A kernel's roofline share is the sum of its calls'
bounds over the sum of their measured times."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float": 67e12, "double": 34e12}
ITEMSIZE = {"float": 4, "double": 8}


def bound_s(nbytes: float, flops: float, value_type: str) -> float:
    """The least time of one call: bytes once over the bandwidth, or
    operations over the type's peak, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[value_type])
