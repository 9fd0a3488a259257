"""Training entry point ``train()``.

Port of ``lightgbm_tpu/engine.py`` ``train`` (:35) for the slice: build a
Booster on the training Dataset, attach validation sets, and run up to
``num_boost_round`` iterations with the reference's callback loop
(:124-152, :188-206): callbacks before and after each iteration, each
group sorted by ``order``; early stopping from ``early_stopping_rounds``
or the ``early_stopping_round`` parameter (:71-72) under
``first_metric_only``; ``verbose_eval`` printing; ``evals_result``
recording; the training metric when the training set is among the valid
sets or under ``is_provide_training_metric``. An ``EarlyStopException``
sets the booster's ``best_iteration`` and ``best_score`` (:272-275).
``fobj`` trains on custom gradients (objective "none", :73-74); ``feval``
(one function or a list) adds its results after the built-in metrics', in
``_run_feval``'s order (:321-335), so they reach ``evals_result``, early
stopping and the callbacks alike. ``fobj`` and ``feval`` see numpy arrays:
the raw score, [N] or [N, K], and the Dataset (``get_label``,
``get_weight``, ``get_group``). ``init_model`` (a model file or a Booster)
continues training: its trees' raw score on the train Dataset's bins is
the train score's init score (``_warm_start``, :337-387), and the valid
sets replay it too; the returned Booster holds the new trees, as in the
reference. Snapshots, faults, the non-finite guard and telemetry
(ROADMAP.md queues A16, A20) are not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as cb
from . import log
from .basic import Booster, Dataset
from .config import canonical_name, params_to_config


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: Union[str, List[str]] = "auto",
          categorical_feature: Union[str, List] = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster (reference: engine.py:35), with the reference's
    parameters in its order but ``resume_from_snapshot`` (ROADMAP.md queue
    A16). ``feature_name`` and ``categorical_feature`` other than "auto"
    are set on the train set (:76-79). ``keep_training_booster`` is
    accepted for the reference's signature: the returned Booster can
    always go on training."""
    params = dict(params or {})
    conf = params_to_config(params)
    if any(canonical_name(str(k)) == "num_iterations" for k in params):
        num_boost_round = conf.num_iterations
    if conf.early_stopping_round and early_stopping_rounds is None:
        early_stopping_rounds = conf.early_stopping_round
    if fobj is not None:
        params = {k: v for k, v in params.items()
                  if canonical_name(str(k)) != "objective"}
        params["objective"] = "none"
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        init = (Booster(model_file=init_model)
                if isinstance(init_model, str) else init_model)
        booster._gbdt.warm_start(init._host_trees())
    valid_sets = list(valid_sets or [])
    valid_names = list(valid_names or [])
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            continue
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs.reference is not train_set:
            vs.reference = train_set
        vs.params = {**train_set.params, **vs.params}
        booster.add_valid(vs, name)
    eval_training = any(vs is train_set for vs in valid_sets) \
        or conf.is_provide_training_metric

    callbacks = list(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(cb.early_stopping(early_stopping_rounds,
                                           conf.first_metric_only,
                                           verbose=bool(verbose_eval)))
    if verbose_eval is True:
        callbacks.append(cb.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval >= 1:
        callbacks.append(cb.print_evaluation(verbose_eval))
    if evals_result is not None:
        callbacks.append(cb.record_evaluation(evals_result))
    before = sorted((c for c in callbacks
                     if getattr(c, "before_iteration", False)),
                    key=lambda c: getattr(c, "order", 0))
    after = sorted((c for c in callbacks
                    if not getattr(c, "before_iteration", False)),
                   key=lambda c: getattr(c, "order", 0))

    begin_iteration = booster.current_iteration
    end_iteration = begin_iteration + num_boost_round
    try:
        for i in range(begin_iteration, end_iteration):
            for c in before:
                c(cb.CallbackEnv(model=booster, params=params, iteration=i,
                                 begin_iteration=begin_iteration,
                                 end_iteration=end_iteration,
                                 evaluation_result_list=None))
            finished = booster.update(fobj=fobj)
            results = []
            if booster._gbdt.valid_sets or eval_training:
                if eval_training:
                    results.extend(booster.eval_train())
                results.extend(booster.eval_valid())
                if feval is not None:
                    results.extend(_run_feval(feval, booster, eval_training))
            for c in after:
                c(cb.CallbackEnv(model=booster, params=params, iteration=i,
                                 begin_iteration=begin_iteration,
                                 end_iteration=end_iteration,
                                 evaluation_result_list=results))
            if finished:
                log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
                break
    except cb.EarlyStopException as e:
        booster.best_iteration = e.best_iteration + 1
        for item in (e.best_score or []):
            booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    return booster


def _run_feval(feval, booster: Booster, eval_training: bool) -> List:
    """Each feval on the training set (when evaluated) and each valid set,
    in the reference's order: feval(raw score as numpy, Dataset) returns
    one (name, value, greater_is_better) or a list of them."""
    gb = booster._gbdt
    sets = [("training", gb.train_score, gb.train_set)] if eval_training \
        else []
    sets += list(zip(gb.valid_names, gb.valid_scores, gb.valid_sets))
    out = []
    for f in (feval if isinstance(feval, (list, tuple)) else [feval]):
        for name, score, ds in sets:
            res = f(np.array(score.cpu().numpy()), ds)
            for metric, value, greater in ([res] if isinstance(res, tuple)
                                           else res):
                out.append((name, metric, value, greater))
    return out
