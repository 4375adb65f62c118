"""Published peaks of one NVIDIA H100 (NVIDIA's data sheet, SXM part,
dense rates, at the full 700 W power limit). A roofline share is stated
against these, with the card's power limit beside it."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # HBM3 bandwidth, bytes/s
