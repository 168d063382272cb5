"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full power limit of 700 W)."""

PEAKS = {
    "bf16_flops": 989e12,          # FLOP/s, bf16 and fp16 on the tensor cores
    "hbm_bytes_per_s": 3.35e12,    # bytes/s of HBM3
}
