"""Dataset and Booster.

Port of the dense numeric construct of ``lightgbm_tpu/basic.py``
``Dataset`` (:95) and of ``Booster`` (``predict``, ``save_model``,
``model_to_string``, loading from model text). The binned matrix lives on
the device as uint8 ``[N, F]`` together with its cached ``[F, N]``
transpose ``bins_T``, which is what the kernels read.

Device rule: ``device_type`` (alias ``device``) defaults to ``"cuda"``.
Without a GPU, constructing a Dataset or a training Booster raises
``RuntimeError`` unless the caller passes ``device_type="cpu"``; nothing
moves to the CPU on its own.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .binning import bin_data, find_bin_mappers, used_features
from . import efb
from .config import Config, check_slice, params_to_config
from .io import model_text
from .log import LightGBMError
from .metrics import create_metrics, default_metric_for_objective
from .models.gbdt import GBDT
from .models.tree import Tree
from .objectives import create_objective
from .ops import predict as P

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
        for what, val, item in (("weight", weight, "A11"),
                                ("group", group, "A11"),
                                ("init_score", init_score, "A14")):
            if val is not None:
                raise NotImplementedError(f"Dataset {what} is not ported yet "
                                          f"(ROADMAP.md queue {item})")
        if categorical_feature not in ("auto", None, [], ()):
            raise NotImplementedError("categorical features are not ported "
                                      "yet (ROADMAP.md queue A12)")
        self.params = dict(params or {})
        self.raw_data = data
        self.label_np = None if label is None else \
            np.asarray(label, dtype=np.float32).reshape(-1)
        self.reference = reference
        self.feature_name = feature_name
        self.free_raw_data = free_raw_data
        self._constructed = False
        self.mappers = []
        self.feature_map: Optional[np.ndarray] = None
        self.bins: Optional[torch.Tensor] = None
        self._bins_T: Optional[torch.Tensor] = None
        self.label: Optional[torch.Tensor] = None
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
                max_bin_by_feature=conf.max_bin_by_feature)
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
        if self.label_np is not None:
            self.label = torch.as_tensor(self.label_np, device=self.device)
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
                "which is not ported yet (ROADMAP.md queue A12); pass "
                "enable_bundle=false to train them as separate columns")

    def feature_names(self) -> List[str]:
        return list(self._names)


class Booster:
    """Trained or training model (reference: lightgbm.Booster)."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = params_to_config(self.params)
        self._gbdt: Optional[GBDT] = None
        self.trees: List[Tree] = []
        self._loaded_meta: Dict[str, Any] = {}
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
        objective = create_objective(conf.objective, conf)
        metrics = create_metrics(
            conf.metric or [default_metric_for_objective(conf.objective)])
        self._gbdt = GBDT(conf, train_set, objective, metrics)
        self.objective = objective

    def add_valid(self, data: Dataset, name: str) -> None:
        data.construct()
        self._gbdt.add_valid(data, name)

    def update(self) -> bool:
        """One boosting iteration; True when no further split was found."""
        return self._gbdt.train_one_iter()

    def num_model_per_iteration(self) -> int:
        return 1

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
        (transformed by the objective unless raw_score), or [N, T] leaf
        indices with pred_leaf."""
        trees = self._host_trees()
        if num_iteration and num_iteration > 0:
            trees = trees[:num_iteration]
        x_np = _to_numpy_2d(data)
        nf = self.num_feature()
        if nf and x_np.shape[1] != nf:
            raise LightGBMError(f"The number of features in data "
                                f"({x_np.shape[1]}) is not the same as it "
                                f"was in training data ({nf})")
        x = torch.as_tensor(x_np, device=self._device()).to(torch.float64)
        if pred_leaf:
            return P.predict_leaf(trees, x).cpu().numpy()
        raw = P.predict_raw(trees, x)
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
        return create_objective(parts[0], conf)

    # ---- persistence ----
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return model_text.dump_model_text(self, self._host_trees(),
                                          num_iteration or -1,
                                          start_iteration)

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
        if meta.get("average_output") or \
                int(meta.get("num_tree_per_iteration", 1)) != 1:
            raise NotImplementedError(
                "models with average_output (RF) or several trees per "
                "iteration (multiclass) are not ported yet (ROADMAP.md "
                "queue A11/A14)")
        self._loaded_meta = meta
        self.trees = trees
