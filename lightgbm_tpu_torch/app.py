"""The command line the reference ships as the
``lightgbm`` binary (src/application/application.cpp:84-252).

Port of ``lightgbm_tpu/app.py``. Usage, with the reference binary's
conventions (``key=value`` arguments override the config file's lines,
main.cpp:26):

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]
    python -m lightgbm_tpu_torch task=train data=binary.train objective=binary

Tasks: ``train`` (through ``engine.train``, so ``snapshot_freq`` and
``resume_from_snapshot`` work as in Python; the model goes to
``output_model``), ``predict`` (``predict_raw_score``,
``predict_leaf_index``, ``predict_contrib``, ``num_iteration_predict``;
results to ``output_result``), ``refit``, ``convert_model`` (C++ to
``convert_model``), ``serve`` (the newline protocol of ``server.py`` over
stdin/stdout, or TCP with ``serve_port``; ``fleet_replicas`` > 1 serves
through a ``FleetServer``) and ``online`` (continuous training,
``online.py``: tail ``online_feed``, append, refit, publish).
Training, prediction and serving run on the GPU unless
``device_type=cpu`` is given. The telemetry knobs (``telemetry``,
``metrics_out``, ``xla_trace_out``) apply to every task: ``train`` exports
through ``engine.train``, ``predict`` and ``refit`` when they finish.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, List

import numpy as np

from . import log, obs
from .basic import Booster, Dataset
from .config import Config, canonical_name
from .engine import train as engine_train
from .io import parser
from .io.parser import load_file
from .utils import atomic_io


def parse_args(argv: List[str]) -> Dict[str, str]:
    """``key=value`` arguments and an optional ``config=file`` whose lines
    are ``key=value`` (``#`` comments); the arguments override the file's
    lines (main.cpp:21-30)."""
    cli = Config.str2map(argv)
    conf_path = None
    for k in list(cli):
        if canonical_name(k) == "config":
            conf_path = cli.pop(k)
    merged: Dict[str, str] = {}
    if conf_path:
        if not os.path.exists(conf_path):
            log.fatal(f"Config file {conf_path} does not exist")
        with open(conf_path) as fh:
            merged.update(Config.str2map(fh.readlines()))
    merged.update(cli)
    return merged


def _load_initscore(path: str) -> np.ndarray:
    """An init-score file (reference: initscore_filename /
    valid_data_initscores, metadata.cpp:521), through the vfs layer."""
    from .io.vfs import exists, open_file
    if not exists(path):
        log.fatal(f"Initial score file {path} does not exist")
    with open_file(path, "rb") as fh:
        init = np.loadtxt(fh, dtype=np.float64)
    log.info(f"Loading initial scores from {path}")
    return init


def _load_dataset(path: str, conf: Config, params: Dict, reference=None,
                  num_features_hint: int = 0,
                  initscore_path: str = "") -> Dataset:
    """A data file as a Dataset: its ``.bin`` cache (``Dataset.save_binary``)
    when there is one, else the parsed text; ``save_binary`` writes the
    cache. With ``num_machines > 1`` and no ``pre_partition`` every rank
    parses the file and keeps its round-robin rows (reference:
    app.py:74, :95-125), and there is no cache: the ranks would race to
    write their own rows to one path."""
    use_bin_cache = not (conf.num_machines > 1 and not conf.pre_partition)
    bin_path = path if path.endswith(".bin") else path + ".bin"
    if use_bin_cache and os.path.exists(bin_path) and reference is None:
        try:
            ds = Dataset.load_binary(bin_path, params=params)
            log.info(f"Loaded binned dataset from {bin_path}")
            if initscore_path:
                ds.set_init_score(_load_initscore(initscore_path))
            return ds
        except log.LightGBMError as e:
            # the reference package's .bin files are pickles of its own
            # classes, which this package does not read
            log.info(f"{bin_path} is not this package's binary Dataset "
                     f"({e}); parsing {path} instead")
    pf = load_file(path, header=conf.header, label_column=conf.label_column,
                   weight_column=conf.weight_column,
                   group_column=conf.group_column,
                   ignore_column=conf.ignore_column,
                   num_features_hint=num_features_hint,
                   two_round=conf.two_round)
    X, label, weight, init = pf.X, pf.label, pf.weight, pf.init_score
    if initscore_path:
        init = _load_initscore(initscore_path)
    if conf.num_machines > 1 and not conf.pre_partition and \
            reference is None:
        if pf.group is not None:
            # the whole file on every rank would count each row
            # num_machines times in the cross-rank sums, and round-robin
            # rows cannot keep a query whole
            log.fatal("num_machines > 1 with query/group data: automatic "
                      "round-robin row sharding cannot split whole "
                      "queries. Pre-partition the data by query and set "
                      "pre_partition=true")
        from .parallel.dist_data import round_robin_rows
        from .parallel.mesh import init_distributed
        from .parallel.multihost import process_count, process_index
        init_distributed(conf)
        if process_count() > 1:
            keep = round_robin_rows(X.shape[0], process_index(),
                                    process_count())
            X = X[keep]
            label, weight, init = (None if v is None else v[keep]
                                   for v in (label, weight, init))
            log.info(f"rank {process_index()}: kept {len(keep)} of "
                     f"{pf.X.shape[0]} rows (round-robin)")
    ds = Dataset(X, label=label, weight=weight, group=pf.group,
                 init_score=init, reference=reference, params=params,
                 feature_name=pf.feature_names or "auto")
    if conf.save_binary and reference is None:
        if use_bin_cache:
            ds.save_binary(bin_path)
        else:
            log.warning("save_binary is ignored for auto-partitioned "
                        "distributed loading (ranks hold different rows); "
                        "use pre_partition=true with per-rank files")
    return ds


def run_train(conf: Config, params: Dict) -> None:
    if not conf.data:
        log.fatal("No training data: set data=<file>")
    t0 = time.perf_counter()
    train_set = _load_dataset(conf.data, conf, params,
                              initscore_path=conf.initscore_filename)
    valid_sets, valid_names = [], []
    vinits = list(conf.valid_data_initscores or [])
    for vi, vpath in enumerate(conf.valid):
        vs = _load_dataset(vpath, conf, params, reference=train_set,
                           initscore_path=(vinits[vi]
                                           if vi < len(vinits) else ""))
        valid_sets.append(vs)
        valid_names.append(os.path.basename(vpath))
    log.info(f"Finished loading data in {time.perf_counter() - t0:.6f} "
             f"seconds (parser: {parser.LAST_PARSE_PATH})")
    t1 = time.perf_counter()
    booster = engine_train(
        params, train_set, num_boost_round=conf.num_iterations,
        valid_sets=valid_sets, valid_names=valid_names,
        init_model=conf.input_model or None,
        verbose_eval=conf.metric_freq if conf.metric_freq > 0 else False)
    dt = time.perf_counter() - t1
    booster.save_model(conf.output_model)
    log.info(f"Finished training {booster.current_iteration} iterations in "
             f"{dt:.6f} seconds "
             f"({dt / max(booster.current_iteration, 1):.6f} s/iteration); "
             f"model saved to {conf.output_model}")


def _load_rows(conf: Config, nf: int):
    pf = load_file(conf.data, header=conf.header,
                   label_column=conf.label_column,
                   weight_column=conf.weight_column,
                   group_column=conf.group_column,
                   ignore_column=conf.ignore_column, num_features_hint=nf,
                   two_round=conf.two_round)
    X = pf.X
    if X.shape[1] < nf:   # a file sparser than the train data (LibSVM)
        X = np.pad(X, ((0, 0), (0, nf - X.shape[1])))
    return pf, X


def run_predict(conf: Config, params: Dict) -> None:
    if not conf.data:
        log.fatal("No data to predict: set data=<file>")
    if not conf.input_model:
        log.fatal("No model file: set input_model=<file>")
    booster = Booster(model_file=conf.input_model, params=params)
    _, X = _load_rows(conf, booster.num_feature())
    t0 = time.perf_counter()
    pred = booster.predict(
        X, raw_score=conf.predict_raw_score,
        pred_leaf=conf.predict_leaf_index, pred_contrib=conf.predict_contrib,
        num_iteration=(conf.num_iteration_predict
                       if conf.num_iteration_predict > 0 else None))
    dt = time.perf_counter() - t0
    log.info(f"Predicted {X.shape[0]} rows in {dt:.3f}s "
             f"({X.shape[0] / max(dt, 1e-9):,.0f} rows/s)")
    out = np.asarray(pred)
    if out.ndim == 1:
        out = out[:, None]
    fmt = "%d" if conf.predict_leaf_index else "%.18g"
    np.savetxt(conf.output_result, out, fmt=fmt, delimiter="\t")
    log.info(f"Finished prediction; results saved to {conf.output_result}")
    _export_telemetry(conf)


def run_refit(conf: Config, params: Dict) -> None:
    """task=refit: the model's tree structures with leaf values refit to
    new data (reference: Application::Refit, application.cpp:215-252)."""
    if not conf.data:
        log.fatal("No data to refit on: set data=<file>")
    if not conf.input_model:
        log.fatal("No model file: set input_model=<file>")
    booster = Booster(model_file=conf.input_model, params=params)
    pf, X = _load_rows(conf, booster.num_feature())
    if pf.label is None:
        log.fatal("Refit requires labels in the data file")
    new_b = booster.refit(X, pf.label, weight=pf.weight, group=pf.group)
    new_b.save_model(conf.output_model)
    log.info(f"Finished refit; model saved to {conf.output_model}")
    _export_telemetry(conf)


def _export_telemetry(conf: Config) -> None:
    """Write the telemetry files of a task that does not train
    (reference: app.py:195); engine.train exports a training run's."""
    out = obs.export_all(conf.metrics_out)
    if out:
        log.info(f"telemetry exported to {out}")


def run_convert_model(conf: Config, params: Dict) -> None:
    if not conf.input_model:
        log.fatal("No model file: set input_model=<file>")
    if conf.convert_model_language not in ("", "cpp"):
        log.fatal(f"convert_model_language={conf.convert_model_language} is "
                  "not supported; only cpp is (config.h:660)")
    from .io.model_text import model_to_cpp
    booster = Booster(model_file=conf.input_model, params=params)
    out = conf.convert_model or "gbdt_prediction.cpp"
    atomic_io.atomic_write_text(out,
                                model_to_cpp(booster, booster._host_trees()))
    log.info(f"Finished converting model; C++ code saved to {out}")


def run_serve(conf: Config, params: Dict) -> None:
    """task=serve: publish input_model into a hot-swappable registry behind
    the request-coalescing microbatcher (server.py) and serve the newline
    protocol, over TCP when serve_port > 0, else over stdin/stdout
    (reference: app.py:227-273).

    Protocol (one line a request):
      ``v1,v2,...``       feature row -> ``<version>\t<score>``
      ``!publish <path>`` atomic hot-swap to a new model version
      ``!canary <path> [fraction] [shadow|canary]`` start a rollout
      ``!promote`` / ``!rollback``   manual rollout transitions
      ``!stats`` / ``!fleet_stats``  one-line JSON
      ``!quit``           shut down

    With ``fleet_replicas > 1`` a :class:`~.fleet.service.FleetServer`
    serves instead: N replicas behind the least-outstanding balancer, the
    same protocol.
    """
    if not conf.input_model:
        log.fatal("No model file: set input_model=<file>")
    from .server import serve_stdio, serve_tcp
    if conf.fleet_replicas > 1:
        from .fleet.service import FleetServer
        server = FleetServer(conf, model=conf.input_model)
        log.info(f"Published {conf.input_model} to {conf.fleet_replicas} "
                 f"{conf.fleet_mode} replicas; serving "
                 f"(window={conf.serve_batch_window_us}us, "
                 f"queue_max={conf.serve_queue_max})")
    else:
        from .server import PredictServer
        server = PredictServer(conf, model=conf.input_model)
        log.info(f"Published {conf.input_model} as version 1; serving "
                 f"(window={conf.serve_batch_window_us}us, "
                 f"queue_max={conf.serve_queue_max}, "
                 f"max_batch_rows={conf.serve_max_batch_rows})")
    flush_owner = obs.start_periodic_flush(conf.metrics_flush_secs)
    try:
        if conf.serve_port > 0:
            serve_tcp(server, "0.0.0.0", conf.serve_port)
        else:
            served = serve_stdio(server, sys.stdin, sys.stdout)
            log.info(f"Finished serving; {served} lines handled")
    finally:
        obs.stop_periodic_flush(flush_owner)
        server.close()
        _export_telemetry(conf)


def run_online(conf: Config, params: Dict) -> None:
    """task=online: continuous training (online.py; reference: app.py:276).
    Train an initial model on ``data`` (or load ``input_model``), then tail
    ``online_feed`` for label-first rows, appending them to the Dataset
    under its frozen bin boundaries and refitting/publishing per the
    ``online_*`` triggers.

    With ``serve_port > 0`` the hot-swapping PredictServer serves the
    newline protocol on that port concurrently (``!learn`` lines feed the
    same trainer) and the feed file is followed until interrupted; with no
    port the feed is drained once and the final model saved — a batch
    catch-up job.

    With ``online_wal=1`` the feed is tailed with per-row batch ids and
    every batch write-ahead-logged, so a crashed run restarted with the
    same params resumes exactly-once: the trainer reloads the committed
    model artifact, replays unacknowledged batches, and the re-read of the
    feed file from the start deduplicates against the logged ids."""
    import threading
    if not conf.data:
        log.fatal("No training data: set data=<file>")
    if not conf.online_feed:
        log.fatal("No streaming feed: set online_feed=<file>")
    train_set = _load_dataset(conf.data, conf, params,
                              initscore_path=conf.initscore_filename)
    if conf.input_model:
        booster = Booster(model_file=conf.input_model, params=params)
    else:
        booster = engine_train(params, train_set,
                               num_boost_round=conf.num_iterations)
    from .online import OnlineTrainer, tail_source
    from .server import PredictServer, serve_tcp
    server = PredictServer(conf, model=booster)
    trainer = OnlineTrainer(params, train_set, booster=booster,
                            server=server)
    server.attach_online(trainer)
    if trainer.recovery:
        log.info(f"online: WAL recovery re-appended "
                 f"{trainer.recovery['committed']} committed and replayed "
                 f"{trainer.recovery['replayed']} pending batches "
                 f"({trainer.recovery['rows']} rows)")
    stop = threading.Event()
    follow = conf.serve_port > 0
    if follow:
        threading.Thread(target=serve_tcp,
                         args=(server, "0.0.0.0", conf.serve_port),
                         daemon=True).start()
    flush_owner = obs.start_periodic_flush(conf.metrics_flush_secs)
    try:
        fed = trainer.run(tail_source(conf.online_feed, stop=stop,
                                      follow=follow,
                                      with_ids=bool(conf.online_wal)),
                          stop=stop)
        log.info(f"online: fed {fed} rows over {trainer.cycles} refit "
                 f"cycles (version {trainer.version})")
    except KeyboardInterrupt:
        stop.set()
        log.info("online: interrupted; flushing pending rows")
        trainer.flush()
    finally:
        obs.stop_periodic_flush(flush_owner)
        server.close()
        trainer.close()
        trainer.booster.save_model(conf.output_model)
        log.info(f"Finished online training; model saved to "
                 f"{conf.output_model}")
        _export_telemetry(conf)


def _configure_logging(conf: Config) -> None:
    """The CLI's log lines on stderr at the level ``verbosity`` asks for."""
    logger = logging.getLogger("lightgbm_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[LightGBM] [%(levelname)s] "
                                         "%(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.INFO if conf.verbosity >= 1 else
                    logging.WARNING if conf.verbosity == 0 else logging.ERROR)


def main(argv: List[str], log_to_stderr: bool = False) -> int:
    """Run one task; ``log_to_stderr`` (the command line's) prints the log
    on stderr at the level ``verbosity`` asks for."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    params = parse_args(argv)
    conf = Config(params)
    if log_to_stderr:
        _configure_logging(conf)
    # the telemetry knobs apply to every task (train applies them again a
    # run; predict and refit see only this one)
    obs.configure_from_config(conf)
    task = conf.task
    if task == "train":
        run_train(conf, params)
    elif task in ("refit", "refit_tree"):
        run_refit(conf, params)
    elif task in ("predict", "prediction", "test"):
        run_predict(conf, params)
    elif task == "convert_model":
        run_convert_model(conf, params)
    elif task == "serve":
        run_serve(conf, params)
    elif task == "online":
        run_online(conf, params)
    else:
        log.fatal(f"Unknown task: {task}")
    return 0
