"""Training callbacks.

Port of ``lightgbm_tpu/callback.py`` (the reference python package's
callback protocol, python-package/lightgbm/callback.py): each callback
receives a ``CallbackEnv`` before or after every iteration, ordered by its
``order``; ``EarlyStopException`` ends the training loop. ``early_stopping``
carries its bookkeeping across a snapshot and resume through
``_es_export``/``_es_import`` (reference: callback.py:144-171).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List

from . import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log the evaluation results every ``period`` iterations."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            log.info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    """Record every evaluation result into ``eval_result[data][metric]``."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for data_name, eval_name, result, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, []).append(result)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters before each iteration, from a list (one value an
    iteration) or a function of the iteration index; the booster takes
    ``learning_rate`` (as the reference's does)."""
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key} has to equal "
                                     "num_boost_round")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
        if new_params:
            if "learning_rate" in new_params and env.model is not None:
                env.model._gbdt.learning_rate = new_params["learning_rate"]
            env.params.update(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop when no validation metric (the first only, under
    ``first_metric_only``) improved for ``stopping_rounds`` iterations, or
    at the last iteration; raises ``EarlyStopException`` with the best
    iteration (0-based) and its evaluation results."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            enabled[0] = False
            return
        if verbose:
            log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1]
        for ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if ret[3]:  # greater is better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i, ret in enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](ret[2], best_score[i]):
                best_score[i] = ret[2]
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and first_metric[0] != ret[1]:
                continue
            if ret[0] == "training":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info(f"Early stopping, best iteration is: "
                             f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log.info(f"Did not meet early stopping. Best iteration "
                             f"is: [{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])

    # snapshot and resume: the closure's state out and in as JSON-able
    # dicts, so a resumed run goes on counting instead of starting over
    def _es_export():
        if not best_score:
            return None
        return {"best_score": list(best_score), "best_iter": list(best_iter),
                "greater": [bool(op(1, 0)) for op in cmp_op],
                "enabled": enabled[0], "first_metric": first_metric[0],
                "best_score_list": [
                    [list(r) for r in lst] if lst is not None else None
                    for lst in best_score_list]}

    def _es_import(state) -> None:
        if not state:
            return
        best_score[:] = [float(v) for v in state["best_score"]]
        best_iter[:] = [int(v) for v in state["best_iter"]]
        cmp_op[:] = [(lambda x, y: x > y) if g else (lambda x, y: x < y)
                     for g in state["greater"]]
        enabled[0] = bool(state["enabled"])
        first_metric[0] = state["first_metric"]
        best_score_list[:] = [
            [tuple(r) for r in lst] if lst is not None else None
            for lst in state["best_score_list"]]

    _callback._es_export = _es_export
    _callback._es_import = _es_import
    _callback.order = 30
    return _callback
