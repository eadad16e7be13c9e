"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit): HBM3 bandwidth, float32 outside the tensor cores,
bfloat16 on the tensor cores."""

BYTES_PER_S = 3.35e12
F32_PER_S = 67e12
BF16_PER_S = 989e12
