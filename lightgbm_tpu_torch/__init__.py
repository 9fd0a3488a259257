"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Trains gradient-boosted trees of the pointwise objectives (the regression
family, binary, multiclass softmax and one-vs-all with K trees an
iteration, cross-entropy) and the ranking ones (lambdarank, rank_xendcg on
query groups), with row weights, init scores or a custom objective, on
dense numeric data (gbdt, GOSS, DART or RF boosting, continued from an
init model or refit; the depthwise grower on int8 quantized gradients or
f32 histograms, or the leaf-wise grower; bagging, feature_fraction and
feature_fraction_bynode; validation sets, the reference's metric table,
custom eval functions, early stopping and callbacks; histogram_pool_size
on both growers; cross-validation ``cv`` and the scikit-learn style
``LGBM*`` estimators; crash-safe snapshots and their resume, the non-finite
guard and fault injection; the command line ``python -m
lightgbm_tpu_torch``, the text parser, a C API, TreeSHAP contributions,
C++ code generation and plotting; a chunked, pipelined Dataset ingest and
a background kernel prewarm; serving through ``serving.PredictEngine``,
the coalescing ``server.PredictServer`` and the ``fleet`` package, over
``task=serve`` or the C API; continuous learning through
``Dataset.append``, ``online.OnlineTrainer`` with its write-ahead feed log
and delayed-label joins, over ``task=online`` or the C API) on
an NVIDIA Hopper GPU through eight hand-written CUDA kernels
(``ops/hist_kernels.py``, ``csrc/``). It imports torch and numpy only:
nothing of JAX and nothing of the ``lightgbm_tpu`` reference package.

``LGBMTPU_LINT_ONLY=1`` skips the API surface, so that ``python -m
lightgbm_tpu_torch.analysis`` (the port's lint) runs without torch.

Entry points run on the GPU (``device_type="cuda"``, the default) unless
the caller passes ``device_type="cpu"``; then every kernel wrapper runs its
plain PyTorch version. Settings outside the ported path raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
import os as _os

if _os.environ.get("LGBMTPU_LINT_ONLY"):
    # Lint-only mode: ``python -m lightgbm_tpu_torch.analysis`` must import
    # this parent package (that is how -m works) but the analyzer is
    # pure-stdlib AST and must never pull in torch. Skip the API surface;
    # the analysis subpackage imports nothing from it.
    __all__ = []
else:
    from .basic import Booster, Dataset
    from .callback import (EarlyStopException, early_stopping,
                           print_evaluation, record_evaluation,
                           reset_parameter)
    from .config import Config
    from .engine import cv, train
    from .log import LightGBMError
    from .plotting import (create_tree_digraph, plot_importance,
                           plot_metric, plot_split_value_histogram,
                           plot_tree)
    from .sklearn import (LGBMClassifier, LGBMModel, LGBMRanker,
                          LGBMRegressor)

    __all__ = ["Dataset", "Booster", "Config", "train", "cv",
               "LightGBMError", "early_stopping", "print_evaluation",
               "record_evaluation", "reset_parameter", "EarlyStopException",
               "LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker",
               "plot_importance", "plot_split_value_histogram",
               "plot_metric", "create_tree_digraph", "plot_tree"]
