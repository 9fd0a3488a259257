"""Training entry point ``train()``.

Port of ``lightgbm_tpu/engine.py`` ``train`` (:35) for the slice: build a
Booster on the training Dataset, attach validation sets, run up to
``num_boost_round`` iterations (stopping early only when a tree cannot
split), and record each iteration's metrics on the validation sets in
``evals_result``. Early stopping and callbacks are ROADMAP queue A9.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .basic import Booster, Dataset
from .config import canonical_name, params_to_config


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          evals_result: Optional[Dict] = None,
          early_stopping_rounds: Optional[int] = None) -> Booster:
    """Train a booster (reference: engine.py:35)."""
    if fobj is not None or feval is not None:
        raise NotImplementedError("custom objectives and eval functions are "
                                  "not ported yet (ROADMAP.md queue A11)")
    if early_stopping_rounds:
        raise NotImplementedError("early stopping is not ported yet "
                                  "(ROADMAP.md queue A9)")
    params = dict(params or {})
    if any(canonical_name(str(k)) == "num_iterations" for k in params):
        num_boost_round = params_to_config(params).num_iterations
    booster = Booster(params=params, train_set=train_set)
    valid_sets = list(valid_sets or [])
    valid_names = list(valid_names or [])
    eval_training = False
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            eval_training = True
            continue
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs.reference is not train_set:
            vs.reference = train_set
        vs.params = {**train_set.params, **vs.params}
        booster.add_valid(vs, name)
    if evals_result is not None:
        evals_result.clear()
    for _ in range(num_boost_round):
        finished = booster.update()
        if evals_result is not None:
            results = booster.eval_valid()
            if eval_training:
                results = booster.eval_train() + results
            for name, metric, value, _gib in results:
                evals_result.setdefault(name, {}).setdefault(
                    metric, []).append(value)
        if finished:
            break
    return booster
