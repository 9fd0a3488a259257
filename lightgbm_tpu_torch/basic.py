"""Dataset and Booster.

Port of the dense construct of ``lightgbm_tpu/basic.py`` ``Dataset``
(:95), with numerical and categorical columns (``categorical_feature``,
:168-182), labels, row weights, query groups and init scores,
and of ``Booster`` (``update`` with a custom objective, ``predict``,
``save_model``, ``model_to_string``, loading from model text, ``refit``),
K trees an iteration for the multiclass objectives, and the trainers of
every boosting type (gbdt, GOSS, DART, RF). The binned matrix lives on the
device as uint8 ``[N, F]`` together with its cached ``[F, N]`` transpose
``bins_T``, which is what the kernels read.

Device rule: ``device_type`` (alias ``device``) defaults to ``"cuda"``.
Without a GPU, constructing a Dataset or a training Booster raises
``RuntimeError`` unless the caller passes ``device_type="cpu"``; nothing
moves to the CPU on its own.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .binning import (BIN_CATEGORICAL, bin_data, find_bin_mappers,
                      used_features)
from . import efb
from .config import Config, boosting_kind, check_slice, params_to_config
from .io import model_text
from .log import LightGBMError
from .metrics import create_metrics, default_metric_for_objective
from .models.dart import DART
from .models.gbdt import GBDT
from .models.goss import GOSS
from .models.rf import RF
from .models.tree import Tree
from .objectives import create_objective
from .ops import predict as P
from .ops.split import SplitParams, leaf_output

_NO_NA_BIN = 256   # na_bin value that never matches a uint8 bin


def resolve_device(conf: Config) -> torch.device:
    """The torch device a config asks for; raises when it is a GPU and no
    GPU is present."""
    kind = str(conf.device_type).lower()
    if kind in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type='cuda' (the default) but no CUDA device is "
                "available; pass device_type='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if kind == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device_type={conf.device_type!r}: expected 'cuda' or "
                     "'cpu'")


def _to_numpy_2d(data) -> np.ndarray:
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype.kind not in "fiub":
        raise LightGBMError(f"unsupported feature dtype {arr.dtype}")
    return arr


class Dataset:
    """Training or validation data (reference: lightgbm.Dataset).

    Lazily constructed: ``construct()`` finds the bin mappers on the host
    (or takes the reference set's) and encodes the uint8 matrix on the
    device."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        if type(data).__module__.split(".")[0] in ("scipy", "pandas"):
            raise NotImplementedError("sparse and pandas input (with pandas "
                                      "categoricals) are not ported yet "
                                      "(ROADMAP.md queue A12b)")
        self.params = dict(params or {})
        self.raw_data = data
        self.label_np = None if label is None else \
            np.asarray(label, dtype=np.float32).reshape(-1)
        self.weight_np = None if weight is None else \
            np.asarray(weight, dtype=np.float32).reshape(-1)
        # query sizes, int64 on the host; init scores f32, [N] or [N, K]
        # once on the device
        self.set_group(group)
        self.init_score_np = None if init_score is None else \
            np.asarray(init_score, dtype=np.float32)
        self.init_score: Optional[torch.Tensor] = None
        self.reference = reference
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.free_raw_data = free_raw_data
        self._constructed = False
        self.mappers = []
        self.feature_map: Optional[np.ndarray] = None
        self.bins: Optional[torch.Tensor] = None
        self._bins_T: Optional[torch.Tensor] = None
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.device: Optional[torch.device] = None
        self._names: List[str] = []
        self.num_data = int(np.shape(data)[0])
        self.num_features_raw = int(np.shape(data)[1]) \
            if np.ndim(data) > 1 else 1

    @property
    def bins_T(self) -> torch.Tensor:
        """Cached [F_used, N] uint8 transpose of ``bins``."""
        if self._bins_T is None:
            self._bins_T = self.bins.t().contiguous()
        return self._bins_T

    @property
    def num_features(self) -> int:
        return int(self.bins.shape[1])

    @property
    def max_num_bins(self) -> int:
        return max((m.num_bins for m in self.mappers), default=1)

    @property
    def has_categorical(self) -> bool:
        return any(m.bin_type == BIN_CATEGORICAL for m in self.mappers)

    def _resolve_categorical(self, conf: Config, ncols: int) -> List[int]:
        """The categorical columns (reference: ``_resolve_categorical``,
        basic.py:168-182): the ``categorical_feature`` argument, else the
        ``categorical_feature`` parameter as LightGBM writes it
        ("0,1,5", or "name:a,b"). Integers are column indices; strings
        name columns through ``feature_name``, as in LightGBM (the
        reference resolves names only against pandas columns, and pandas
        input is not ported)."""
        cf = self.categorical_feature
        if cf in ("auto", None):
            text = str(conf.categorical_feature).strip().strip("[]")
            if not text:
                return []
            by_name = text.startswith("name:")
            items = [t.strip() for t in text[5 if by_name else 0:].split(",")
                     if t.strip()]
            cf = items if by_name else [int(t) for t in items]
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else [])
        out = []
        for c in (cf if isinstance(cf, (list, tuple)) else [cf]):
            if isinstance(c, (int, np.integer)) and not isinstance(c, bool):
                out.append(int(c))
            elif isinstance(c, str) and c in names:
                out.append(names.index(c))
        return sorted(set(j for j in out if 0 <= j < ncols))

    def construct(self) -> "Dataset":
        if self._constructed:
            return self
        conf = params_to_config(self.params)
        check_slice(conf)
        self.device = resolve_device(conf)
        raw = _to_numpy_2d(self.raw_data)
        if self.reference is not None:
            ref = self.reference.construct()
            if ref.device != self.device:
                raise ValueError("a validation Dataset must live on its "
                                 "reference's device")
            self.mappers, self.feature_map = ref.mappers, ref.feature_map
            self._names = ref._names
        else:
            mappers = find_bin_mappers(
                raw, max_bin=conf.max_bin, min_data_in_bin=conf.min_data_in_bin,
                sample_cnt=conf.bin_construct_sample_cnt,
                use_missing=conf.use_missing,
                zero_as_missing=conf.zero_as_missing,
                seed=conf.data_random_seed,
                max_bin_by_feature=conf.max_bin_by_feature,
                categorical=self._resolve_categorical(conf, raw.shape[1]))
            used = used_features(mappers)
            self.mappers = [mappers[j] for j in used]
            self.feature_map = np.asarray(used, dtype=np.int32)
            self._names = (list(self.feature_name)
                           if isinstance(self.feature_name, (list, tuple))
                           else [f"Column_{i}" for i in range(raw.shape[1])])
        if self.reference is None and conf.enable_bundle:
            self._refuse_bundles(conf, raw)
        self.bins = bin_data(raw, self.mappers, list(self.feature_map),
                             self.device)
        na = np.array([m.na_bin for m in self.mappers], dtype=np.int32)
        self.na_bin_dev = torch.as_tensor(
            np.where(na < 0, _NO_NA_BIN, na).astype(np.int32),
            device=self.device)
        self.num_bins_dev = torch.as_tensor(
            np.array([m.num_bins for m in self.mappers], dtype=np.int32),
            device=self.device)
        for what, arr in (("label", self.label_np),
                          ("weight", self.weight_np)):
            if arr is None:
                continue
            if arr.shape[0] != self.num_data:
                raise LightGBMError(f"length of {what} ({arr.shape[0]}) "
                                    "differs from the number of rows "
                                    f"({self.num_data})")
            setattr(self, what, torch.as_tensor(arr, device=self.device))
        if self.group is not None and int(self.group.sum()) != self.num_data:
            raise LightGBMError(f"sum of the query sizes "
                                f"({int(self.group.sum())}) differs from the "
                                f"number of rows ({self.num_data})")
        if self.init_score_np is not None:
            if self.init_score_np.size % max(self.num_data, 1):
                raise LightGBMError(f"init_score has {self.init_score_np.size}"
                                    f" values for {self.num_data} rows")
            self.init_score = torch.as_tensor(self.init_score_np,
                                              device=self.device)
        self._constructed = True
        if self.free_raw_data:
            self.raw_data = None
        return self

    def _refuse_bundles(self, conf: Config, raw: np.ndarray) -> None:
        """Raise when the reference would bundle this data's features (EFB,
        not ported yet): its plan decision, replayed on the same sample."""
        idx = efb.plan_sample_index(raw.shape[0], conf.data_random_seed)
        sample = raw if idx is None else raw[idx]
        sample_bins = np.stack(
            [m.values_to_bins(sample[:, j]).astype(np.uint8)
             for m, j in zip(self.mappers, self.feature_map)], axis=1)
        if efb.would_bundle(sample_bins, self.mappers, conf.max_conflict_rate,
                            conf.sparse_threshold):
            raise NotImplementedError(
                "the reference would bundle these sparse features (EFB), "
                "which is not ported yet (ROADMAP.md queue A12b); pass "
                "enable_bundle=false to train them as separate columns")

    def feature_names(self) -> List[str]:
        return list(self._names)

    def get_label(self) -> Optional[np.ndarray]:
        return self.label_np

    def get_weight(self) -> Optional[np.ndarray]:
        return self.weight_np

    def get_group(self) -> Optional[np.ndarray]:
        return self.group

    def set_group(self, group) -> "Dataset":
        self.group = None if group is None else \
            np.asarray(group, dtype=np.int64).reshape(-1)
        return self

    def get_init_score(self) -> Optional[np.ndarray]:
        return self.init_score_np


class Booster:
    """Trained or training model (reference: lightgbm.Booster).

    ``best_iteration`` (-1 until early stopping sets it) is the iteration
    count ``predict``, ``model_to_string`` and ``save_model`` use when
    called without ``num_iteration``."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = params_to_config(self.params)
        self._gbdt: Optional[GBDT] = None
        self.trees: List[Tree] = []
        self._loaded_meta: Dict[str, Any] = {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.train_set: Optional[Dataset] = None
        if model_file is not None:
            with open(model_file) as fh:
                self._load_model_string(fh.read())
        elif model_str is not None:
            self._load_model_string(model_str)
        elif train_set is not None:
            self._setup_train(train_set)

    # ---- training ----
    def _setup_train(self, train_set: Dataset) -> None:
        check_slice(self.config)
        train_set.params = {**self.params, **train_set.params}
        train_set.construct()
        if train_set.label is None:
            raise LightGBMError("the training Dataset needs a label")
        self.train_set = train_set
        conf = self.config
        # None for a custom objective (objective="none", as train() sets it
        # for fobj)
        objective = create_objective(conf.objective, conf)
        metrics = create_metrics(
            conf.metric or [default_metric_for_objective(conf.objective)],
            conf)
        # the trainer of the boosting type (reference: booster_class,
        # basic.py:1010)
        trainer = {"gbdt": GBDT, "goss": GOSS, "dart": DART,
                   "rf": RF}[boosting_kind(conf.boosting)]
        self._gbdt = trainer(conf, train_set, objective, metrics)
        self.objective = objective

    def add_valid(self, data: Dataset, name: str) -> None:
        data.construct()
        self._gbdt.add_valid(data, name)

    def update(self, fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration; True when no further split was found.

        ``fobj(score, train_set) -> (grad, hess)`` is called with the raw
        training score as a numpy array, [N] or [N, K], and may return
        [N] / [N, K] arrays or row-major flat ones of N * K values
        (reference: Booster.update, basic.py:1100-1117)."""
        gb = self._gbdt
        if fobj is None:
            return gb.train_one_iter()
        grad, hess = fobj(gb.train_score.cpu().numpy().copy(), gb.train_set)
        shape = tuple(gb.train_score.shape)
        rows = []
        for what, a in (("grad", grad), ("hess", hess)):
            a = np.asarray(a, dtype=np.float32)
            if a.size != gb.train_score.numel():
                raise LightGBMError(f"fobj returned {a.size} {what} values "
                                    f"for a score of shape {shape}")
            rows.append(torch.as_tensor(a.reshape(shape), device=gb.device))
        return gb.train_one_iter(*rows)

    @property
    def current_iteration(self) -> int:
        return self._gbdt.iter_ if self._gbdt else \
            len(self.trees) // self.num_model_per_iteration()

    def num_model_per_iteration(self) -> int:
        if self._gbdt is not None:
            return self._gbdt.num_tree_per_iteration
        return int(self._loaded_meta.get("num_tree_per_iteration", 1))

    def num_trees(self) -> int:
        return self._gbdt.num_trees() if self._gbdt else len(self.trees)

    def eval_train(self):
        return self._gbdt.eval_train()

    def eval_valid(self):
        return self._gbdt.eval_valid()

    # ---- prediction ----
    def _host_trees(self) -> List[Tree]:
        if self._gbdt is not None:
            self.trees = self._gbdt.finalize()
        return self.trees

    def _device(self) -> torch.device:
        if self.train_set is not None:
            return self.train_set.device
        return resolve_device(self.config)

    def num_feature(self) -> int:
        if self.train_set is not None:
            return self.train_set.num_features_raw
        return int(self._loaded_meta.get("max_feature_idx", -1)) + 1

    def feature_name(self) -> List[str]:
        if self.train_set is not None:
            return self.train_set.feature_names()
        return list(self._loaded_meta.get("feature_names", []))

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False
                ) -> np.ndarray:
        """Predictions on raw features [N, F] as a numpy array: f64 scores
        (transformed by the objective unless raw_score), [N] or, with K
        trees an iteration, [N, K]; or [N, T] leaf indices with
        pred_leaf."""
        trees = self._host_trees()
        k = self.num_model_per_iteration()
        if num_iteration is None:
            num_iteration = self._default_num_iteration()
        if num_iteration > 0:
            trees = trees[:num_iteration * k]
        x_np = _to_numpy_2d(data)
        nf = self.num_feature()
        if nf and x_np.shape[1] != nf:
            raise LightGBMError(f"The number of features in data "
                                f"({x_np.shape[1]}) is not the same as it "
                                f"was in training data ({nf})")
        x = torch.as_tensor(x_np, device=self._device()).to(torch.float64)
        if pred_leaf:
            return P.predict_leaf(trees, x).cpu().numpy()
        raw = P.predict_raw(trees, x, k)
        if self.average_output() and trees:
            raw = raw / (len(trees) // k)
        if not raw_score:
            obj = self._objective_for_predict()
            if obj is not None:
                raw = obj.convert_output(raw)
        return raw.cpu().numpy()

    def _objective_for_predict(self):
        if self._gbdt is not None:
            return self.objective
        name = self._loaded_meta.get("objective", "")
        if not name:
            return None
        conf = self.config.copy()
        parts = name.split(" ")
        for p in parts[1:]:
            if ":" in p:
                kk, vv = p.split(":", 1)
                conf.update({kk: vv})
        try:
            return create_objective(parts[0], conf)
        except LightGBMError:
            # an objective the port does not know: raw scores, as the
            # reference predicts then
            return None

    def average_output(self) -> bool:
        """Whether the model's output is the mean of its iterations (RF)."""
        if self._gbdt is not None:
            return self._gbdt.average_output
        return bool(self._loaded_meta.get("average_output", False))

    def refit(self, data, label, decay_rate: Optional[float] = None,
              weight=None, group=None) -> "Booster":
        """A new Booster with this model's tree structures and leaf values
        refit to new data (reference: Booster.refit, basic.py:1318-1362):
        the rows' leaves from ``predict(pred_leaf=True)``; per tree, the
        gradients of the model's objective at the score of the trees
        refit so far, on the port's device; their leaf sums on the host in
        f64, the regularized leaf outputs ``ops/split.leaf_output`` in f32
        times the tree's shrinkage, blended as ``decay * old + (1 - decay)
        * new``."""
        conf = params_to_config(self.params)
        decay = conf.refit_decay_rate if decay_rate is None else decay_rate
        new_b = Booster(model_str=self.model_to_string(), params=self.params)
        trees = new_b._host_trees()
        if not trees:
            raise LightGBMError("Cannot refit an empty model")
        x = _to_numpy_2d(data)
        dev = self._device()
        obj = new_b._objective_for_predict()
        if obj is None:
            raise LightGBMError("Cannot refit: model has no objective")
        y = torch.as_tensor(np.asarray(label, dtype=np.float32).reshape(-1),
                            device=dev)
        w = None if weight is None else torch.as_tensor(
            np.asarray(weight, dtype=np.float32).reshape(-1), device=dev)
        obj.init(y, w, None if group is None
                 else np.asarray(group, dtype=np.int64))
        k = new_b.num_model_per_iteration()
        n = x.shape[0]
        leaf_mat = np.asarray(self.predict(x, pred_leaf=True))
        score = np.zeros(n) if k == 1 else np.zeros((n, k))
        sp = SplitParams(lambda_l1=conf.lambda_l1, lambda_l2=conf.lambda_l2,
                         max_delta_step=conf.max_delta_step)
        grad = hess = None
        for ti, t in enumerate(trees):
            cls = ti % k
            if cls == 0:
                g_dev, h_dev = obj.get_gradients(torch.as_tensor(
                    score, dtype=torch.float32, device=dev))
                grad, hess = g_dev.cpu().numpy(), h_dev.cpu().numpy()
            g = grad if k == 1 else grad[:, cls]
            h = hess if k == 1 else hess[:, cls]
            leaf = leaf_mat[:, ti]
            sg = np.bincount(leaf, weights=g, minlength=t.num_leaves)
            sh = np.bincount(leaf, weights=h, minlength=t.num_leaves) + 1e-15
            new_out = leaf_output(
                torch.as_tensor(sg, dtype=torch.float32),
                torch.as_tensor(sh, dtype=torch.float32), sp).numpy() \
                * np.float32(t.shrinkage)
            t.leaf_value = decay * t.leaf_value + (1.0 - decay) * new_out
            delta = t.leaf_value[leaf]
            if k == 1:
                score = score + delta
            else:
                score[:, cls] += delta
        return new_b

    # ---- persistence ----
    def _default_num_iteration(self) -> int:
        """The iteration count of a call without num_iteration: the best
        iteration once early stopping set it, else all (reference:
        basic.py:1230, :1387)."""
        return self.best_iteration if self.best_iteration > 0 else -1

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        if num_iteration is None:
            num_iteration = self._default_num_iteration()
        return model_text.dump_model_text(self, self._host_trees(),
                                          num_iteration, start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        text = self.model_to_string(num_iteration, start_iteration)
        tmp = f"{filename}.tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, filename)
        return self

    def _load_model_string(self, s: str) -> None:
        meta, trees = model_text.parse_model_text(s)
        self._loaded_meta = meta
        self.trees = trees
        self.best_iteration = -1
