"""One run of one cell: set-up, the measured window, the traced stretch,
the check, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in BENCHMARK.json: ``configs/<config>.json`` (its rows'
generator ``gen/<generator>.py`` and the port's parameters),
``traffic/<traffic>.json`` (the parameters the mix adds, the warm-up and
the traced iterations), ``limits/<cell>.json`` (the limit of each number
compared), ``e2e_metrics/<name>.py`` and ``layer_metrics/<name>.py``.

The window drives the port's own entry, ``lightgbm_tpu_torch.train``, with
the validation set's metric every iteration, as users run it. The harness
enters it through one callback, ``Window``, which synchronises the card at
the window's edges and ends the loop with ``EarlyStopException``. The
warm-up is the same call's first iterations, before the window opens.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import tempfile
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import judge, program, trace
from .work.needed import Shape

HERE = os.path.dirname(os.path.abspath(__file__))
# modules that must not be loaded by the time the window closes, compared
# by whole top-level name (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")
CARD_BYTES = 80e9


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str] = field(default_factory=dict)

    @property
    def params(self) -> dict:
        return {**self.config["params"], **self.traffic.get("params", {})}


def load_cell(root: str, name: str) -> Cell:
    bench = load_json(root, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Cell(name, load_json(root, cfg["file"]),
                load_json(HERE, "traffic", cell["traffic"] + ".json"),
                load_json(HERE, "limits", name + ".json"),
                [m["name"] for m in bench["end_to_end"]],
                [m["name"] for m in bench["per_layer"]],
                {m["name"]: m["unit"]
                 for m in bench["end_to_end"] + bench["per_layer"]})


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Window:
    """engine.train's after-iteration callback that opens the window after
    ``warmup`` iterations, closes it once ``seconds`` have passed and, when
    traced, profiles ``profile_iterations`` more."""
    order = 1000

    def __init__(self, warmup: int, seconds: float, profile_iterations: int,
                 traced: bool, device: torch.device):
        self.warmup, self.seconds = warmup, seconds
        self.profile_iterations, self.traced = profile_iterations, traced
        self.device = device
        self.phase = "warmup"
        self.metric = float("nan")
        self.t_open = self.t_close = 0.0
        self.it_open = self.it_close = self.it_prof = self.last_it = 0
        self.profile: Optional[trace.Profile] = None
        self.profile_tries = 0
        self._prof = None
        # the draws of the trees the check judges: the first ones, and the
        # window's last ones (device tensors the program made; no copy)
        self.first: Dict[int, tuple] = {}
        self.recent: Deque[Tuple[int, tuple]] = deque(
            maxlen=judge.CHECKED_TREES)
        # host clock at the end of each iteration in the window
        self.marks: List[float] = []

    def checked(self) -> Dict[int, tuple]:
        """The draws of the trees the check judges, by tree index."""
        return {**self.first, **dict(self.recent)}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_profile(self, it: int) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.it_prof = it
        self.profile_tries += 1

    def _stop_profile(self, it: int) -> trace.Profile:
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            p = trace.load_chrome(path, it - self.it_prof)
        self._prof = None
        return p

    def __call__(self, env) -> None:
        from lightgbm_tpu_torch.callback import EarlyStopException
        it = env.iteration + 1
        self.last_it = it
        if it <= judge.CHECKED_TREES:
            self.first[it - 1] = program.draws(env.model)
        elif self.phase == "window":
            self.recent.append((it - 1, program.draws(env.model)))
        if env.evaluation_result_list:
            self.metric = float(env.evaluation_result_list[-1][2])
        if self.phase == "warmup":
            if it >= self.warmup:
                self.sync()
                self.t_open, self.it_open = time.perf_counter(), it
                self.phase = "window"
            return
        if self.phase == "window":
            self.marks.append(time.perf_counter())
            if self.marks[-1] - self.t_open < self.seconds:
                return
            self.sync()
            self.t_close, self.it_close = time.perf_counter(), it
            if not self.traced:
                raise EarlyStopException(env.iteration, [])
            self.phase = "profile"
            self._start_profile(it)
            return
        if it - self.it_prof < self.profile_iterations:
            return
        self.sync()
        p = self._stop_profile(it)
        if self.device.type == "cuda" and not p.device:
            # CUPTI sometimes hands back no device events: once more, then
            # the run fails rather than report a zero
            if self.profile_tries < 2:
                self._start_profile(it)
                return
            raise RuntimeError("the profiler recorded no device operation")
        self.profile = p
        raise EarlyStopException(env.iteration, [])


@dataclass
class EndToEndContext:
    setup_s: float
    window_s: float
    window_iterations: int


@dataclass
class LayerContext:
    profile: Optional[trace.Profile]
    construct_s: float
    shape: Shape
    bandwidth: float
    flops: float
    window_iter_s: float
    window_trees: list = field(default_factory=list)
    profiled_trees: list = field(default_factory=list)


def read_metrics(kind: str, names: List[str], ctx, units: Dict[str, str]
                 ) -> Dict[str, dict]:
    out = {}
    for name in names:
        mod = importlib.import_module(f"gbdt_bench.{kind}.{name}")
        v = mod.read(ctx)
        if v is not None:
            out[name] = {"value": float(v), "unit": units.get(name, "")}
    return out


def shape_of(cell: Cell, host, B: int) -> Shape:
    extra = 0.0
    if host.group_train is not None:
        # LambdaRank's pairs: about 30 operations a (first-T doc, doc) cell
        t = int(cell.params.get("lambdarank_truncation_level", 20))
        g = np.asarray(host.group_train, dtype=np.float64)
        extra = 30.0 * float((np.minimum(g, t) * g).sum())
    bagged = float(cell.params.get("bagging_fraction", 1.0)) < 1.0
    return Shape(rows_train=int(host.x_train.shape[0]),
                 rows_valid=int(host.x_valid.shape[0]),
                 features=int(host.x_train.shape[1]), bins=B,
                 chan_bytes=2 + int(bagged),
                 num_leaves=int(cell.params["num_leaves"]),
                 extra_grad_flops=extra)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             info: Callable[[str], None] = print,
             plant: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``plant`` (tests only) is called with the imported port before the
    run, to break the timed path underneath."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    gen = importlib.import_module(f"gbdt_bench.gen.{cell.config['generator']}")
    made = gen.make(cell.config, seed, dev)
    host = made.to("cpu")
    del made
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params = {**cell.params, "device_type": device, "verbose": -1}
    lt = program.import_port()
    if plant is not None:
        plant(lt)
    train_set, valid_set = program.datasets(lt, host, params)
    t0 = time.perf_counter()
    train_set.construct()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    construct_s = time.perf_counter() - t0
    valid_set.construct()
    info("construct_phases " + json.dumps(train_set.construct_phases,
                                          default=float))
    if dev.type == "cuda":
        info("build_info " + json.dumps(program.load_library(),
                                        default=str))
    win = Window(int(cell.traffic.get("warmup_iterations", 3)), seconds,
                 int(cell.traffic.get("profile_iterations", 5)), traced, dev)
    booster = lt.train(params, train_set, num_boost_round=10 ** 7,
                       valid_sets=[valid_set], callbacks=[win],
                       verbose_eval=False)
    win.sync()
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    n_window = win.it_close - win.it_open
    steps = np.diff([win.t_open] + win.marks)
    info("window " + json.dumps({
        "iterations": n_window, "seconds": win.t_close - win.t_open,
        "iteration_s_quartiles": (np.percentile(steps, [25, 50, 75]).tolist()
                                  if len(steps) else []),
        **program.tree_shape(booster), "launches": program.launches()}))
    info("memory " + json.dumps({"peak_bytes": peak,
                                 "share_of_80GB": peak / CARD_BYTES}))
    out = program.outputs(booster, train_set, valid_set, win.metric,
                          win.last_it, win.checked())
    del booster, train_set, valid_set
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    e2e = EndToEndContext(win.t_open - t_start, win.t_close - win.t_open,
                          n_window)
    result: dict = {}
    if traced:
        # the split search's padded bins a column
        max_bin = int(cell.params.get("max_bin", 255))
        B = next(b for b in (64, 128, 256) if b >= max_bin)
        bw, fl = card_peaks(dev)
        lctx = LayerContext(
            win.profile, construct_s, shape_of(cell, host, B), bw, fl,
            (win.t_close - win.t_open) / max(n_window, 1),
            window_trees=out.trees[win.it_open:win.it_close],
            profiled_trees=out.trees[win.it_prof:win.it_prof
                                     + (win.profile.iterations
                                        if win.profile else 0)])
        metrics = read_metrics("layer_metrics", cell.per_layer, lctx,
                               cell.units)
    else:
        metrics = read_metrics("e2e_metrics", cell.end_to_end, e2e,
                               cell.units)
    t_check = time.perf_counter()
    try:
        prob = judge.Problem(cell.params, host, dev)
        read = judge.readings(prob, out)
        del prob
    except Exception:   # the check itself failed: not correct, say why
        traceback.print_exc()
        read = {}
    info(f"check_seconds {time.perf_counter() - t_check:.3f}")
    correct, rows = judge.compare(read, cell.limits)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    if traced and win.profile is not None:
        dev_info["busy_s"] = trace.busy_s(win.profile)
        dev_info["window_s"] = win.profile.window_s
    result.update(correct=bool(correct), attempted=int(n_window), failed=0,
                  metrics=metrics, device=dev_info)
    if traced and win.profile is not None:
        result["breakdown"] = trace.breakdown(win.profile)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def card_peaks(dev: torch.device):
    from .hw import peaks
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    return peaks(name)


class ForbiddenModules(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__("loaded in the measuring process: "
                         + ", ".join(names))
        self.names = names
