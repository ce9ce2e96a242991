"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).

``MFU_PEAK`` is the bf16 tensor-core rate: the fastest any product of the
benchmark's configurations can run (the float32 and TF32 rates are lower),
so a share of it cannot pass 100% whatever precision a later change moves
the products to.
"""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
MFU_PEAK = BF16_FLOPS
