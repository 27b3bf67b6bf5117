"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # tensor cores, bf16 dense
FP32_FLOPS = 67e12         # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
