"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below 700 W runs
slower; the benchmark prints the card's power limit beside its shares."""

DENSE_FLOPS = 989e12        # bf16 / fp16 tensor cores, the highest rate
HBM_BYTES_PER_S = 3.35e12   # 80 GB HBM3
