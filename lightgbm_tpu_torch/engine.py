"""Training entry points ``train()`` and ``cv()``.

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
reference. ``cv`` (:390) trains one Booster a fold on subsets of one
constructed Dataset. ``snapshot_freq`` writes a crash-safe snapshot every
that many iterations (``snapshot.py``; a write that still fails after its
retries warns and training goes on, :237-270), ``resume_from_snapshot``
continues from the newest valid one (:92-170), the ``tree_update`` fault
point sits at the top of each iteration (:185-187), and each evaluation
result passes the non-finite guard (``_check_eval_finite``, :296-318).
Telemetry (``obs/``) is wired as the reference wires it: the config's
knobs and a fresh ``TIMER`` namespace at the start (:62-66), the
``resume`` event (:113), the ``xla_trace_out`` capture and the periodic
flush around the loop (:173-181, :276-279), the ``boosting`` and ``eval``
spans (``obs/tracing.py``; at ``verbosity >= 2`` every span of the
iteration is timed into the table), a ``train_iter`` event with the
``train_iterations`` counter, the ``train_iter_seconds`` histogram and the
device-memory gauges each iteration (:193-230), and the ``phase_seconds``
gauges and ``export_all`` at the end (:283-291).
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as cb
from . import log
from . import obs
from . import snapshot as snap
from .obs import tracing
from .utils import faults
from .utils.timer import TIMER
from .basic import Booster, Dataset
from .config import canonical_name, objective_kind, params_to_config

# the objectives whose folds are whole queries
RANKING_OBJECTIVES = ("lambdarank", "rank_xendcg")


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
          callbacks: Optional[List[Callable]] = None,
          resume_from_snapshot: Optional[Union[str, bool]] = None
          ) -> Booster:
    """Train a booster (reference: engine.py:35), with the reference's
    parameters in its order. ``feature_name`` and ``categorical_feature``
    other than "auto" are set on the train set (:76-79).
    ``keep_training_booster`` is accepted for the reference's signature:
    the returned Booster can always go on training.

    ``resume_from_snapshot`` names a snapshot directory (True: the one
    ``snapshot_dir`` gives): the newest valid snapshot there is loaded and
    training continues from its iteration, with ``num_boost_round`` the
    total, so that the resumed run ends where the uninterrupted one would
    have, with its model text. With nothing valid there, or a snapshot of
    another configuration, it warns and trains from scratch."""
    params = dict(params or {})
    conf = params_to_config(params)
    obs.configure_from_config(conf)
    # a fresh timing namespace a run (the previous run's table stays in
    # TIMER.last_run)
    TIMER.begin_run()
    if conf.faults:
        faults.configure(conf.faults)
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
    # restore the trainer before the valid sets attach, so that their
    # replay sees the loaded trees
    resumed = False
    es_resume_state = None
    if resume_from_snapshot:
        resume_dir = (snap.snapshot_dir_for(conf)
                      if resume_from_snapshot is True
                      else str(resume_from_snapshot))
        payload = snap.load_latest_valid(resume_dir)
        if payload is None:
            log.warning(f"resume_from_snapshot: no valid snapshot under "
                        f"{resume_dir!r}; training from scratch")
        else:
            try:
                booster._gbdt.set_resume_state(payload.arrays, payload.meta)
                es_resume_state = payload.es_state
                resumed = True
                log.info(f"resumed from {payload.model_path} "
                         f"(iteration {payload.iteration})")
                obs.emit("resume", iteration=int(payload.iteration),
                         path=payload.model_path, source="snapshot",
                         num_shards=1, snapshot_shards=int(
                             payload.meta.get("num_shards", 1) or 1))
            except ValueError as e:
                log.warning(f"cannot resume from {payload.model_path}: {e}; "
                            "training from scratch")
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

    if es_resume_state is not None:
        for c in callbacks:
            imp = getattr(c, "_es_import", None)
            if imp is not None:
                imp(es_resume_state)

    begin_iteration = booster.current_iteration
    if resumed:
        # num_boost_round is the total on resume
        end_iteration = max(begin_iteration, num_boost_round)
        if begin_iteration >= num_boost_round:
            log.warning(f"snapshot already at iteration {begin_iteration} >= "
                        f"num_boost_round={num_boost_round}; no further "
                        "boosting")
    else:
        end_iteration = begin_iteration + num_boost_round
    snapshot_dir = snap.snapshot_dir_for(conf)
    nf_eval_warned: set = set()
    tele = obs.enabled()
    # the timing table times every span of the loop, not just these two
    table_was = tracing.set_timing_table(conf.verbosity >= 2)
    tracing.maybe_start_xla_trace(conf.xla_trace_out)
    # metrics_flush_secs > 0: live re-export during the loop; the ownership
    # token keeps a nested train from stopping an outer run's flusher
    flush_owner = obs.start_periodic_flush(conf.metrics_flush_secs)
    try:
        for i in range(begin_iteration, end_iteration):
            if tele:
                t_iter0 = time.perf_counter()
            # the kill-and-resume crash: an armed tree_update fault leaves
            # train() like a crash at iteration i
            faults.fault_point("tree_update")
            for c in before:
                c(cb.CallbackEnv(model=booster, params=params, iteration=i,
                                 begin_iteration=begin_iteration,
                                 end_iteration=end_iteration,
                                 evaluation_result_list=None))
            with tracing.span("boosting", timed=True):
                finished = booster.update(fobj=fobj)
            results = []
            if booster._gbdt.valid_sets or eval_training:
                with tracing.span("eval", timed=True):
                    if eval_training:
                        results.extend(booster.eval_train())
                    results.extend(booster.eval_valid())
                    if feval is not None:
                        results.extend(_run_feval(feval, booster,
                                                  eval_training))
                _check_eval_finite(results, conf.nonfinite_policy,
                                   nf_eval_warned, i)
            for c in after:
                c(cb.CallbackEnv(model=booster, params=params, iteration=i,
                                 begin_iteration=begin_iteration,
                                 end_iteration=end_iteration,
                                 evaluation_result_list=results))
            if tele:
                _iteration_telemetry(booster, train_set, i,
                                     time.perf_counter() - t_iter0)
            if conf.snapshot_freq > 0 and (i + 1) % conf.snapshot_freq == 0:
                _write_snapshot(booster, callbacks, snapshot_dir, i + 1,
                                conf.snapshot_keep)
            if finished:
                log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
                break
    except cb.EarlyStopException as e:
        booster.best_iteration = e.best_iteration + 1
        for item in (e.best_score or []):
            booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
    finally:
        # the capture brackets the boosting loop and survives fatal exits
        tracing.stop_xla_trace()
        tracing.set_timing_table(table_was)
        obs.stop_periodic_flush(flush_owner)
    if conf.verbosity >= 2:
        log.debug(TIMER.summary_string())
    if tele:
        for name, rec in TIMER.snapshot().items():
            obs.METRICS.gauge("phase_seconds", "TIMER phase wall time",
                              phase=name).set(rec["seconds"])
        out = obs.export_all(conf.metrics_out)
        if out:
            log.info(f"telemetry exported to {out}")
    return booster


def _iteration_telemetry(booster: Booster, train_set: Dataset, i: int,
                         seconds: float) -> None:
    """Iteration i's telemetry (reference: engine.py:213-230): the
    train_iter event with its wall clock, rows a second and the last
    trees' stats, the train_iterations counter, the train_iter_seconds
    histogram and the device-memory gauges."""
    fields = {"iteration": i + 1, "duration_s": seconds,
              "rows_per_s": train_set.num_data / seconds if seconds > 0
              else 0.0}
    fields.update(booster._gbdt.obs_lagged_stats() or {})
    obs.emit("train_iter", **fields)
    obs.METRICS.counter("train_iterations",
                        "boosting iterations completed").inc()
    obs.METRICS.histogram("train_iter_seconds",
                          "iteration wall time").observe(seconds)
    obs.memory.update_gauges(obs.METRICS)


def _write_snapshot(booster: Booster, callbacks, directory: str,
                    iteration: int, keep: int) -> None:
    """A periodic snapshot with early stopping's state (reference:
    engine.py:237-270): one that still fails after its retries warns, and
    training goes on."""
    es_state = None
    for c in callbacks:
        exp = getattr(c, "_es_export", None)
        if exp is not None:
            es_state = exp()
    try:
        # rank-uniform in practice: _gbdt is None on EVERY rank or none
        # (boosters construct identically before the loop), and
        # write_snapshot enters the same get_resume_state collective the
        # elif arm does
        # tpu-lint: disable=collective-divergence
        if snap.is_writer_rank():
            path = snap.write_snapshot(booster, directory, iteration,
                                       keep=keep, es_state=es_state)
            log.info(f"Saved snapshot to {path}")
        elif booster._gbdt is not None:
            # across processes get_resume_state gathers the lazy-CEGB
            # bitset from every rank's rows (multihost.gather_rows_tensor)
            # -- a COLLECTIVE every rank must enter even though only the
            # writer rank touches the disk
            booster._gbdt.get_resume_state()
    except Exception as e:
        log.warning(f"snapshot at iteration {iteration} failed after "
                    f"retries ({type(e).__name__}: {e}); training continues")


def _check_eval_finite(results, policy: str, warned: set,
                       iteration: int) -> None:
    """The non-finite guard on evaluation results (reference: engine.py
    :296-318): under fatal a non-finite value raises naming its metric,
    the other policies warn once a (dataset, metric)."""
    for r in results:
        name, metric, val = r[0], r[1], r[2]
        try:
            finite = math.isfinite(float(val))
        except (TypeError, ValueError):
            continue
        if finite:
            continue
        if policy == "fatal":
            log.fatal(f"non-finite eval value {val!r} for {name}'s {metric} "
                      f"at iteration {iteration + 1} "
                      "(nonfinite_policy=fatal)")
        if (name, metric) not in warned:
            warned.add((name, metric))
            log.warning(f"non-finite eval value {val!r} for {name}'s "
                        f"{metric} at iteration {iteration + 1} "
                        f"(nonfinite_policy={policy})")


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
            # feval's API takes the score as numpy (reference: engine.py
            # _run_feval): a copy an iteration and eval set, only with a feval
            with tracing.span("sync.feval"):
                # tpu-lint: disable=host-sync-in-jit
                host = np.array(score.cpu().numpy())
            res = f(host, ds)
            for metric, value, greater in ([res] if isinstance(res, tuple)
                                           else res):
                out.append((name, metric, value, greater))
    return out


def stratified_folds(label: np.ndarray, nfold: int, shuffle: bool,
                     seed: int) -> List:
    """(train, test) row indices of ``nfold`` folds that keep each class's
    share: the folds of scikit-learn's StratifiedKFold(nfold, shuffle,
    random_state=seed), which the reference's cv draws, without importing
    scikit-learn. Classes are numbered in order of first appearance, the
    rows of each class dealt to the folds by a round robin over the sorted
    labels, in blocks, and each class's fold numbers shuffled by
    RandomState(seed)."""
    y = np.asarray(label).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_enc = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    if np.all(nfold > np.bincount(y_enc)):
        raise log.LightGBMError(f"nfold={nfold} cannot be greater than the "
                                "number of members in each class")
    y_order = np.sort(y_enc)
    allocation = np.asarray([np.bincount(y_order[i::nfold],
                                         minlength=n_classes)
                             for i in range(nfold)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(len(y), dtype=np.int64)
    for k in range(n_classes):
        folds_k = np.arange(nfold).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_k)
        test_folds[y_enc == k] = folds_k
    rows = np.arange(len(y))
    return [(rows[test_folds != i], rows[test_folds == i])
            for i in range(nfold)]


def make_folds(train_set: Dataset, conf, nfold: int, stratified: bool,
               shuffle: bool, seed: int) -> List:
    """The reference's fold maker (engine.py:413-447): whole queries for
    a ranking objective (the queries permuted by RandomState(seed) and
    split into nfold runs), stratified folds for binary and multiclass
    under ``stratified``, else the rows permuted by RandomState(seed) and
    split into nfold runs."""
    rng = np.random.RandomState(seed)
    n = train_set.num_data
    if objective_kind(conf.objective) in RANKING_OBJECTIVES:
        group = np.asarray(train_set.group)
        nq = len(group)
        q_order = rng.permutation(nq) if shuffle else np.arange(nq)
        bounds = np.concatenate([[0], np.cumsum(group)])
        folds = []
        for part in np.array_split(q_order, nfold):
            va_q = np.zeros(nq, bool)
            va_q[part] = True

            def rows_of(qs):
                return (np.concatenate([np.arange(bounds[q], bounds[q + 1])
                                        for q in qs]) if len(qs)
                        else np.empty(0, np.int64))
            folds.append((rows_of(np.flatnonzero(~va_q)),
                          rows_of(np.flatnonzero(va_q))))
        return folds
    if stratified and conf.objective in ("binary", "multiclass",
                                         "multiclassova"):
        return stratified_folds(train_set.get_label(), nfold, shuffle, seed)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    return [(np.setdiff1d(idx, part, assume_unique=False), part)
            for part in np.array_split(idx, nfold)]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj: Optional[Callable] = None,
       feval: Optional[Callable] = None,
       init_model: Optional[Union[str, Booster]] = None,
       feature_name: Union[str, List[str]] = "auto",
       categorical_feature: Union[str, List] = "auto",
       early_stopping_rounds: Optional[int] = None,
       fpreproc: Optional[Callable] = None,
       verbose_eval: Union[bool, int, None] = None, show_stdv: bool = True,
       seed: int = 0, callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """K-fold cross-validation (reference: engine.py:390-510).

    The folds (``folds`` as (train, test) index pairs, or ``make_folds``)
    are ``Dataset.subset``s of the one constructed ``train_set``, so that
    binning happens once. Each round updates every fold's Booster and
    records the mean and standard deviation of each valid metric over the
    folds as "<metric>-mean" / "<metric>-stdv". ``early_stopping_rounds``
    stops when the first metric's mean has not improved for that many
    rounds and cuts the results to the best round, as the reference does;
    ``callbacks`` run before and after each round with the
    ("cv_agg", metric, mean, greater_is_better, stdv) results, and an
    ``EarlyStopException`` they raise cuts the results to its best
    iteration. ``feval`` adds its results to each fold's;
    ``return_cvbooster`` returns the fold Boosters under "cvbooster"."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    conf = params_to_config(params)
    if any(canonical_name(str(k)) == "num_iterations" for k in params):
        num_boost_round = conf.num_iterations
    if conf.early_stopping_round and early_stopping_rounds is None:
        early_stopping_rounds = conf.early_stopping_round
    if fobj is not None:
        params = {k: v for k, v in params.items()
                  if canonical_name(str(k)) != "objective"}
        params["objective"] = "none"
    if objective_kind(conf.objective) in RANKING_OBJECTIVES \
            and train_set.group is None:
        raise log.LightGBMError("cv() with a ranking objective needs "
                                "query/group information on the Dataset")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    train_set.params = {**params, **train_set.params}
    train_set.construct()
    if folds is None:
        folds = make_folds(train_set, conf, nfold, stratified, shuffle, seed)
    init = None
    if init_model is not None:
        init = (Booster(model_file=init_model)
                if isinstance(init_model, str) else init_model)
    boosters = []
    for tr_idx, va_idx in folds:
        dtr = train_set.subset(tr_idx, params=params)
        dva = train_set.subset(va_idx, params=params)
        fold_params = params
        if fpreproc is not None:
            dtr, dva, fold_params = fpreproc(dtr, dva, dict(params))
        bst = Booster(params=fold_params, train_set=dtr)
        if init is not None:
            bst._gbdt.warm_start(init._host_trees())
        dva.reference = dtr
        bst.add_valid(dva, "valid")
        boosters.append(bst)

    callbacks = list(callbacks or [])
    if verbose_eval is True:
        callbacks.append(cb.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval >= 1:
        callbacks.append(cb.print_evaluation(verbose_eval, show_stdv))
    before = sorted((c for c in callbacks
                     if getattr(c, "before_iteration", False)),
                    key=lambda c: getattr(c, "order", 0))
    after = sorted((c for c in callbacks
                    if not getattr(c, "before_iteration", False)),
                   key=lambda c: getattr(c, "order", 0))
    results: Dict[str, Any] = {}
    best_mean, best_iter = None, 0
    for i in range(num_boost_round):
        env = dict(model=boosters, params=params, iteration=i,
                   begin_iteration=0, end_iteration=num_boost_round)
        for c in before:
            c(cb.CallbackEnv(evaluation_result_list=None, **env))
        allres: Dict = {}
        for bst in boosters:
            bst.update(fobj=fobj)
            res = (bst.eval_train() if eval_train_metric else []) \
                + bst.eval_valid()
            if feval is not None:
                res += _run_feval(feval, bst, eval_train_metric)
            for name, metric, val, gib in res:
                key = metric if name == "valid" else f"{name} {metric}"
                allres.setdefault((key, gib), []).append(val)
        res_list = []
        for (metric, gib), vals in allres.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results.setdefault(f"{metric}-mean", []).append(mean)
            results.setdefault(f"{metric}-stdv", []).append(std)
            res_list.append(("cv_agg", metric, mean, gib, std))
        try:
            for c in after:
                c(cb.CallbackEnv(evaluation_result_list=res_list, **env))
        except cb.EarlyStopException as e:
            for k in results:
                results[k] = results[k][:e.best_iteration + 1]
            break
        if early_stopping_rounds:
            (metric, gib), vals = next(iter(allres.items()))
            mean = float(np.mean(vals))
            if best_mean is None or (mean > best_mean if gib
                                     else mean < best_mean):
                best_mean, best_iter = mean, i
            elif i - best_iter >= early_stopping_rounds:
                for k in results:
                    results[k] = results[k][:best_iter + 1]
                break
    if return_cvbooster:
        results["cvbooster"] = boosters
    return results
