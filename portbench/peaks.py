"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet
for the H100 SXM part, at its full 700 W power limit)."""

#: HBM3 bandwidth, bytes per second
H100_HBM_BYTES_S = 3.35e12
