"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit)."""
H100_SXM = dict(
    fp64_tensor_flops=67e12,
    tf32_tensor_flops=495e12,
    hbm_bytes_per_s=3.35e12,
)
