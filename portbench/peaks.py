"""Published peaks of the card (NVIDIA H100 SXM data sheet, at its
700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
