"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Trains binary-logloss and L2 gradient-boosted trees on dense numeric data
with the depthwise grower and int8 quantized gradients, on an NVIDIA Hopper
GPU through four hand-written CUDA kernels (``ops/hist_kernels.py``,
``csrc/``). It imports torch and numpy only: nothing of JAX and nothing of
the ``lightgbm_tpu`` reference package.

Entry points run on the GPU (``device_type="cuda"``, the default) unless
the caller passes ``device_type="cpu"``; then every kernel wrapper runs its
plain PyTorch version. Settings outside the ported path raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from .basic import Booster, Dataset
from .config import Config
from .engine import train

__all__ = ["Booster", "Config", "Dataset", "train"]
