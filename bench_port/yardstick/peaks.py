"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit): device-memory bytes/s and f32 FLOP/s outside the
tensor cores, the rate the configurations' f32 arithmetic runs at."""

H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
