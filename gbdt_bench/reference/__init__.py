"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy only: it imports nothing of the program under test
(``lightgbm_tpu_torch``) and nothing of the JAX package. It takes the raw
rows, labels and query sizes that the benchmark made, works out again what
the program derives from them (bin bounds and bins, gradients and their
stochastic-rounding quantization, the split search, leaf values, scores and
the validation metric) and judges the program's outputs against that.
"""
