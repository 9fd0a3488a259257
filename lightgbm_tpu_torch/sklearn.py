"""scikit-learn style estimators.

Port of ``lightgbm_tpu/sklearn.py`` (:21-321): ``LGBMModel`` and its
``LGBMRegressor``, ``LGBMClassifier`` (labels encoded to 0..K-1 in sorted
order, ``classes_``, ``predict_proba``, multiclass with ``num_class``) and
``LGBMRanker``, and the adapters of sklearn-style objective and eval
functions. Like the reference it does not import scikit-learn: the
"balanced" class weights and the regressor's R^2 are computed here, so the
estimators run where scikit-learn is absent. They train through
``engine.train`` with the parameters ``_make_train_params`` gives, so a
fitted estimator's model is the one ``train`` makes of those parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train as _train

_PARAM_NAMES = (
    "boosting_type", "num_leaves", "max_depth", "learning_rate",
    "n_estimators", "subsample_for_bin", "objective", "class_weight",
    "min_split_gain", "min_child_weight", "min_child_samples", "subsample",
    "subsample_freq", "colsample_bytree", "reg_alpha", "reg_lambda",
    "random_state", "n_jobs", "silent", "importance_type")


def _argc(func) -> int:
    return func.__code__.co_argcount


class _ObjectiveFunctionWrapper:
    """fobj(y_true, y_pred[, group]) -> (grad, hess) as train's fobj
    (reference: sklearn.py:21)."""

    def __init__(self, func):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = _argc(self.func)
        if argc == 2:
            return self.func(labels, np.asarray(preds))
        if argc == 3:
            return self.func(labels, np.asarray(preds), dataset.get_group())
        raise TypeError("Self-defined objective takes 2 or 3 arguments, "
                        f"got {argc}")


class _EvalFunctionWrapper:
    """feval(y_true, y_pred[, weight[, group]]) -> (name, value,
    greater_is_better) as train's feval (reference: sklearn.py:40)."""

    def __init__(self, func):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = _argc(self.func)
        if argc == 2:
            return self.func(labels, np.asarray(preds))
        if argc == 3:
            return self.func(labels, np.asarray(preds), dataset.get_weight())
        if argc == 4:
            return self.func(labels, np.asarray(preds), dataset.get_weight(),
                             dataset.get_group())
        raise TypeError("Self-defined eval function takes 2-4 arguments")


def compute_sample_weight(class_weight, y) -> np.ndarray:
    """Each row's class weight: "balanced" gives class c the weight
    N / (K * count(c)), a dict its value (1 for a class it omits); the
    function of scikit-learn's compute_sample_weight on one label column."""
    y = np.asarray(y).reshape(-1)
    classes, inv = np.unique(y, return_inverse=True)
    if class_weight == "balanced":
        per_class = len(y) / (len(classes) * np.bincount(inv))
    else:
        per_class = np.array([float(class_weight.get(c, 1.0))
                              for c in classes.tolist()])
    return per_class[inv.reshape(-1)]


class LGBMModel:
    """The estimator base (reference: sklearn.py:59)."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100,
                 subsample_for_bin=200000, objective=None, class_weight=None,
                 min_split_gain=0.0, min_child_weight=1e-3,
                 min_child_samples=20, subsample=1.0, subsample_freq=0,
                 colsample_bytree=1.0, reg_alpha=0.0, reg_lambda=0.0,
                 random_state=None, n_jobs=-1, silent=True,
                 importance_type="split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self._objective = objective
        self._evals_result = None
        self._best_iteration = None
        self._best_score = None

    # ---- sklearn plumbing ----
    def get_params(self, deep=True) -> Dict[str, Any]:
        params = {k: getattr(self, k) for k in _PARAM_NAMES}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _make_train_params(self) -> Dict[str, Any]:
        """The parameters ``fit`` trains with (reference:
        sklearn.py:124-138)."""
        params = self.get_params()
        for key in ("silent", "importance_type", "n_estimators",
                    "class_weight", "random_state", "n_jobs"):
            params.pop(key, None)
        params["objective"] = ("none" if callable(self._objective)
                               else self._objective or "regression")
        params["verbosity"] = -1 if self.silent else 1
        if self.random_state is not None:
            params["seed"] = int(self.random_state)
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False, feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMModel":
        """Train ``n_estimators`` iterations on (X, y) (reference:
        sklearn.py:140-188); an eval set that is the training data itself
        is evaluated as the training set."""
        params = self._make_train_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        fobj = (_ObjectiveFunctionWrapper(self._objective)
                if callable(self._objective) else None)
        feval = (_EvalFunctionWrapper(eval_metric)
                 if callable(eval_metric) else None)
        if self.class_weight is not None and self._n_classes is None:
            sample_weight = self._apply_class_weight(y, sample_weight)
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            categorical_feature=categorical_feature,
                            feature_name=feature_name)
        valid_sets, valid_names = [], []
        for i, (vx, vy) in enumerate(eval_set or []):
            if vx is X and vy is y:
                valid_sets.append(train_set)
            else:
                valid_sets.append(train_set.create_valid(
                    vx, label=vy,
                    weight=eval_sample_weight[i] if eval_sample_weight
                    else None,
                    group=eval_group[i] if eval_group else None,
                    init_score=eval_init_score[i] if eval_init_score
                    else None))
            valid_names.append(eval_names[i] if eval_names else f"valid_{i}")
        evals_result: Dict = {}
        self._Booster = _train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=valid_names, fobj=fobj,
            feval=feval, early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks)
        self._evals_result = evals_result
        self._n_features = (np.shape(X)[1] if hasattr(X, "shape")
                            else len(X[0]))
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self.fitted_ = True
        return self

    def _apply_class_weight(self, y, sample_weight):
        cw = compute_sample_weight(self.class_weight, y)
        return cw if sample_weight is None else np.asarray(sample_weight) * cw

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        """The booster's predictions (reference: sklearn.py:189-201); extra
        keyword arguments go on to ``Booster.predict``."""
        if self._Booster is None:
            raise ValueError("Estimator not fitted")
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise ValueError("No booster found; call fit first")
        return self._Booster

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def n_features_(self):
        return self._n_features

    @property
    def n_features_in_(self):
        return self._n_features

    @property
    def feature_importances_(self):
        return self.booster_.feature_importance(self.importance_type)

    @property
    def feature_name_(self):
        return self.booster_.feature_name()


class LGBMRegressor(LGBMModel):
    """Reference: sklearn.py:247."""

    def fit(self, X, y, **kwargs):
        if self._objective is None:
            self._objective = "regression"
        return super().fit(X, y, **kwargs)

    def score(self, X, y) -> float:
        """R^2 of the predictions."""
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        resid = ((y - self.predict(X)) ** 2).sum()
        return float(1.0 - resid / ((y - y.mean()) ** 2).sum())


class LGBMClassifier(LGBMModel):
    """Reference: sklearn.py:260."""

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        y_enc = np.searchsorted(self._classes, y)
        if self._n_classes > 2:
            if self._objective is None or self._objective == "multiclass":
                self._objective = "multiclass"
            self._other_params["num_class"] = self._n_classes
        elif self._objective is None:
            self._objective = "binary"
        if self.class_weight is not None:
            kwargs["sample_weight"] = self._apply_class_weight(
                y_enc, kwargs.get("sample_weight"))
        return super().fit(X, y_enc, **kwargs)

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score=raw_score,
                                    num_iteration=num_iteration,
                                    pred_leaf=pred_leaf,
                                    pred_contrib=pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        idx = (np.argmax(result, axis=1) if self._n_classes > 2
               else (result[:, 1] > 0.5).astype(int))
        return self._classes[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=None,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        result = super().predict(X, raw_score=raw_score,
                                 num_iteration=num_iteration,
                                 pred_leaf=pred_leaf,
                                 pred_contrib=pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes <= 2 and result.ndim == 1:
            return np.stack([1.0 - result, result], axis=1)
        return result

    def score(self, X, y) -> float:
        """Accuracy of the predicted classes."""
        return float((self.predict(X) == np.asarray(y)).mean())

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    """Reference: sklearn.py:310."""

    def fit(self, X, y, group=None, eval_group=None,
            eval_at=(1, 2, 3, 4, 5), **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if self._objective is None:
            self._objective = "lambdarank"
        self._other_params.setdefault("metric", "ndcg")
        self._other_params["eval_at"] = list(eval_at)
        return super().fit(X, y, group=group, eval_group=eval_group,
                           **kwargs)
