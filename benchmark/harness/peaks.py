"""Published peaks of one NVIDIA H100 (NVIDIA's data sheet, SXM part,
dense rates without sparsity), at its full power limit of 700 W. A card
set below that limit runs slower; the run reports the limit beside every
share of a peak."""

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
MEMORY_BYTES = 80e9
POWER_LIMIT_W = 700.0
