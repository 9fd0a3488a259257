"""The benchmark of lightgbm_tpu_torch on one NVIDIA H100 (see README.md)."""
