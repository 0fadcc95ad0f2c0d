"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

HBM_BYTES_PER_S = 3.35e12     # HBM3
INT8_OPS_PER_S = 1979e12      # int8 tensor cores
