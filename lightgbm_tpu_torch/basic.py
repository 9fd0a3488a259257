"""Dataset and Booster.

Port of the construct of ``lightgbm_tpu/basic.py`` ``Dataset`` (:95) from
numpy arrays, scipy-sparse matrices (:234-292) and pandas DataFrames
(``_data_from_pandas``, :46-71: category columns become their codes),
with numerical and categorical columns (``categorical_feature``,
:168-182), Exclusive Feature Bundling of sparse columns (``efb.py``),
labels, row weights, query groups and init scores, and of ``Booster``
(``update`` with a custom objective, ``predict``, ``save_model``,
``model_to_string``, loading from model text, ``refit``),
K trees an iteration for the multiclass objectives, and the trainers of
every boosting type (gbdt, GOSS, DART, RF). The binned matrix lives on the
device as uint8 ``[N, F]`` (F the bundle columns under EFB) together with
its cached ``[F, N]`` transpose ``bins_T``, which is what the kernels
read. scipy is imported only for a sparse matrix and pandas only for a
DataFrame: neither is needed for numpy input.

Device rule: ``device_type`` (alias ``device``) defaults to ``"cuda"``.
Without a GPU, constructing a Dataset or a training Booster raises
``RuntimeError`` unless the caller passes ``device_type="cpu"``; nothing
moves to the CPU on its own.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .binning import (BIN_CATEGORICAL, BinMapper, bin_data_sparse,
                      bin_sparse_column, find_bin_mappers,
                      find_bin_mappers_sparse, used_features)
from . import efb, obs
from .config import (Config, boosting_kind, canonical_name, check_slice,
                     params_to_config)
from .io import model_text
from .log import LightGBMError, info, warning
from .metrics import (QueryGrid, create_metrics,
                      default_metric_for_objective)
from .models.dart import DART
from .models.gbdt import GBDT
from .models.goss import GOSS
from .models.rf import RF
from .models.tree import Tree
from .objectives import create_objective
from .obs.tracing import span
from .ops import predict as P
from .ops.split import SplitParams, leaf_output
from .utils import atomic_io

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


def _json_scalar(o):
    """numpy scalars in a JSON header as Python numbers."""
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def _is_sparse(data) -> bool:
    """Whether ``data`` is a scipy.sparse matrix (scipy is imported only
    for an object of its package)."""
    if type(data).__module__.split(".")[0] != "scipy":
        return False
    import scipy.sparse
    return scipy.sparse.issparse(data)


def _pandas_of(data):
    """The pandas module when ``data`` is a DataFrame, else None (pandas
    is imported only for an object of its package, and may be absent)."""
    if type(data).__module__.split(".")[0] != "pandas":
        return None
    try:
        import pandas
    except ImportError:
        return None
    return pandas if isinstance(data, pandas.DataFrame) else None


def _data_from_pandas(df, pd, pandas_categorical: Optional[List] = None):
    """A DataFrame as f64 rows and its category lists (reference:
    _data_from_pandas, basic.py:46-71): a category column becomes its
    codes under ``pandas_categorical`` (the training categories; captured
    from the frame when None), -1 (NaN, unseen) becomes NaN; an object or
    string column is fatal."""
    cat_cols = [c for c, dt in zip(df.columns, df.dtypes)
                if isinstance(dt, pd.CategoricalDtype)]
    bad = [str(c) for c, dt in zip(df.columns, df.dtypes)
           if c not in cat_cols and (dt == object
                                     or pd.api.types.is_string_dtype(dt))]
    if bad:
        raise LightGBMError("DataFrame.dtypes must be int, float or bool; "
                            "did you mean astype('category') for columns "
                            f"{', '.join(bad)}?")
    if pandas_categorical is None:
        pandas_categorical = [list(df[c].cat.categories) for c in cat_cols]
    elif len(cat_cols) != len(pandas_categorical):
        raise LightGBMError("train and valid/predict DataFrames have "
                            "different numbers of categorical columns")
    if cat_cols:
        df = df.copy(deep=False)
        for c, cats in zip(cat_cols, pandas_categorical):
            codes = (df[c].cat.set_categories(cats).cat.codes
                     .to_numpy(dtype=np.float64))
            df[c] = np.where(codes < 0, np.nan, codes)
    arr = df.to_numpy(dtype=np.float64, na_value=np.nan)
    # pandas may hand out a read-only array (copy on write)
    return (arr if arr.flags.writeable else arr.copy()), pandas_categorical


def _to_numpy_2d(data, pandas_categorical: Optional[List] = None
                 ) -> np.ndarray:
    pd = _pandas_of(data)
    if pd is not None:
        return _data_from_pandas(data, pd, pandas_categorical)[0]
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype.kind not in "fiub":
        raise LightGBMError(f"unsupported feature dtype {arr.dtype}")
    return arr


# the trainer of each boosting type (reference: booster_class,
# basic.py:1010)
TRAINERS = {"gbdt": GBDT, "goss": GOSS, "dart": DART, "rf": RF}


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
        # the EFB plan (None: every used feature its own column), the
        # category lists of a DataFrame's category columns, and the
        # construct's seconds by phase
        self.bundle_meta: Optional[efb.BundleMeta] = None
        self.pandas_categorical: Optional[List] = None
        self.construct_phases: Dict[str, float] = {}
        self._max_num_bins = 1
        self.bins: Optional[torch.Tensor] = None
        self._bins_T: Optional[torch.Tensor] = None
        # the row-shard plan of a mesh (parallel/mesh.RowShardPlan, None on
        # one shard) and the shards' [rows_per_shard, F] bin blocks, each on
        # its shard's device, the padding rows zero
        self.shard_plan = None
        # a train set over several processes: (its first row among every
        # process's rows, the rows of all), else None
        self._pod_rows_of: Optional[Tuple[int, int]] = None
        self.shard_bins: Optional[List[torch.Tensor]] = None
        self._shard_bins_T: Optional[List[torch.Tensor]] = None
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.device: Optional[torch.device] = None
        # the background kernel warm-up of the construct (prewarm.py)
        self._prewarm = None
        self._names: List[str] = []
        # data None: a Dataset that subset or load_binary fills in
        self.num_data = 0 if data is None else int(np.shape(data)[0])
        self.num_features_raw = (0 if data is None else
                                 int(np.shape(data)[1]) if np.ndim(data) > 1
                                 else 1)

    @property
    def bins_T(self) -> torch.Tensor:
        """Cached [F_used, N] uint8 transpose of ``bins``."""
        if self._bins_T is None:
            self._bins_T = self.bins.t().contiguous()
        return self._bins_T

    @property
    def shard_bins_T(self) -> Optional[List[torch.Tensor]]:
        """The shards' [F, rows_per_shard] blocks (cached transposes of
        ``shard_bins``), which the kernels of each shard read."""
        if self._shard_bins_T is None and self.shard_bins is not None:
            self._shard_bins_T = [b.t().contiguous()
                                  for b in self.shard_bins]
        return self._shard_bins_T

    def _set_shards(self, plan, blocks=None) -> None:
        """Adopt a row-shard plan and its blocks (split from ``bins`` when
        not given)."""
        self.shard_plan = plan
        self._shard_bins_T = None
        self.shard_bins = (None if plan is None else
                           blocks if blocks is not None
                           else plan.split(self.bins))

    @property
    def num_features(self) -> int:
        return int(self.bins.shape[1])

    def num_feature(self) -> int:
        """The number of feature columns of the raw data (reference:
        Dataset.num_feature, basic.py:884)."""
        return self.num_features_raw or self.num_features

    @property
    def max_num_bins(self) -> int:
        """The most bins of a column of ``bins`` (a bundle column's under
        EFB)."""
        return self._max_num_bins

    @property
    def has_categorical(self) -> bool:
        return any(m.bin_type == BIN_CATEGORICAL for m in self.mappers)

    @property
    def routes_by_membership(self) -> bool:
        """Whether a tree on these bins may hold membership (is_cat) nodes:
        a categorical column or an EFB bundle."""
        return self.has_categorical or self.bundle_meta is not None

    def _resolve_categorical(self, conf: Config, ncols: int,
                             columns: Optional[List] = None) -> List[int]:
        """The categorical columns (reference: ``_resolve_categorical``,
        basic.py:168-182): the ``categorical_feature`` argument; else a
        DataFrame's category columns (``columns``: its column labels);
        else the ``categorical_feature`` parameter as LightGBM writes it
        ("0,1,5", or "name:a,b"). Integers are column indices; strings
        name columns through ``feature_name``, or a DataFrame's labels
        (the reference resolves names only against the labels)."""
        cf = self.categorical_feature
        pd = _pandas_of(self.raw_data)
        if cf in ("auto", None) and pd is not None:
            return [i for i, dt in enumerate(self.raw_data.dtypes)
                    if isinstance(dt, pd.CategoricalDtype)]
        if cf in ("auto", None):
            text = str(conf.categorical_feature).strip().strip("[]")
            if not text:
                return []
            by_name = text.startswith("name:")
            items = [t.strip() for t in text[5 if by_name else 0:].split(",")
                     if t.strip()]
            cf = items if by_name else [int(t) for t in items]
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple))
                 else list(columns or []))
        out = []
        for c in (cf if isinstance(cf, (list, tuple)) else [cf]):
            if isinstance(c, (int, np.integer)) and not isinstance(c, bool):
                out.append(int(c))
            elif isinstance(c, str) and c in names:
                out.append(names.index(c))
        return sorted(set(j for j in out if 0 <= j < ncols))

    def construct(self) -> "Dataset":
        """Bin the rows on the device (reference: _construct_inner,
        basic.py:187-292): the train set finds its mappers (from a
        sample's stored values for sparse input) and its EFB plan; a valid
        set takes its reference's mappers, plan and pandas categories.
        Timed as the ``dataset_construct`` span (basic.py:186)."""
        if self._constructed:
            return self
        with span("dataset_construct", timed=True):
            return self._construct_inner()

    def _construct_inner(self) -> "Dataset":
        conf = params_to_config(self.params)
        check_slice(conf)
        if conf.num_threads and conf.num_threads > 0:
            # the native parser's and binner's worker threads (reference:
            # basic.py:192-194)
            from .native import set_num_threads
            set_num_threads(conf.num_threads)
        # a train set over several processes holds this process's rows
        # only (reference: basic.py:259-268, :295-395); the group starts
        # first, since it picks this process's card
        pod = False
        if conf.num_machines > 1 and self.reference is None:
            from .parallel.mesh import init_distributed
            from .parallel.multihost import process_count
            init_distributed(conf)
            pod = process_count() > 1
        self.device = resolve_device(conf)
        phases = self.construct_phases = {}
        t_last = time.perf_counter()

        def mark(name: str) -> None:
            nonlocal t_last
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            phases[name] = now - t_last
            t_last = now

        sparse = _is_sparse(self.raw_data)
        if pod and sparse:
            # bins found from one process's stored values would differ
            # from the others' and corrupt the cross-rank sums
            raise LightGBMError("scipy-sparse input is not supported with "
                                "num_machines > 1; densify it")
        if pod and self.group is not None:
            raise LightGBMError("query groups are not supported with "
                                "num_machines > 1: a query cannot span "
                                "processes")
        if self.reference is not None:
            ref = self.reference.construct()
            if ref.device != self.device:
                raise ValueError("a validation Dataset must live on its "
                                 "reference's device")
            self.mappers, self.feature_map = ref.mappers, ref.feature_map
            self._names = ref._names
            self.bundle_meta = ref.bundle_meta
            self.pandas_categorical = ref.pandas_categorical
            raw = (self.raw_data.tocsc() if sparse else
                   _to_numpy_2d(self.raw_data, self.pandas_categorical))
        else:
            columns = None
            pd = _pandas_of(self.raw_data)
            if sparse:
                # binned column by column: no dense f64 copy
                raw = self.raw_data.tocsc()
            elif pd is not None:
                raw, self.pandas_categorical = _data_from_pandas(
                    self.raw_data, pd)
                columns = list(self.raw_data.columns)
            else:
                raw = _to_numpy_2d(self.raw_data)
            find = find_bin_mappers_sparse if sparse else find_bin_mappers
            forced_bins = None
            if conf.forcedbins_filename:
                # a JSON list of {"feature", "bin_upper_bound"} (reference:
                # basic.py:245-256)
                with open(conf.forcedbins_filename) as fh:
                    forced_bins = {int(e["feature"]): e["bin_upper_bound"]
                                   for e in json.load(fh)}
            bin_kw = dict(
                max_bin=conf.max_bin, min_data_in_bin=conf.min_data_in_bin,
                sample_cnt=conf.bin_construct_sample_cnt,
                use_missing=conf.use_missing,
                zero_as_missing=conf.zero_as_missing,
                seed=conf.data_random_seed,
                max_bin_by_feature=conf.max_bin_by_feature,
                categorical=self._resolve_categorical(conf, raw.shape[1],
                                                      columns),
                forced_bins=forced_bins)
            if pod:
                mappers = self._pod_rows(conf, raw, bin_kw, mark)
            else:
                mappers = find(raw, **bin_kw)
            used = used_features(mappers)
            self.mappers = [mappers[j] for j in used]
            self.feature_map = np.asarray(used, dtype=np.int32)
            if isinstance(self.feature_name, (list, tuple)):
                self._names = list(self.feature_name)
            elif columns is not None:
                self._names = [str(c) for c in columns]
            else:
                self._names = [f"Column_{i}" for i in range(raw.shape[1])]
            mark("find_bins_s")
            self.bundle_meta = self._plan_efb(conf, raw, sparse)
            mark("efb_plan_s")
            # the row-shard plan (pure metadata) is published before the
            # ingest, so that the chunk routing, the prewarm and the trainer
            # agree on one grid (reference: basic.py:351-373)
            self._plan_shards(conf, raw.shape[0])
            if pod:
                self._pod_plan_check(conf, raw.shape[0])
                mark("rows_allgather_s")
            if not sparse:
                # the mappers and the plan fix the kernel path: load and
                # warm the kernels while the bulk ingest below runs
                from . import prewarm
                self._prewarm = prewarm.maybe_start(conf, self)
        self._encode(raw, sparse, conf, phases)
        mark("stream_s")
        if pod:
            # the trainer's row-length state is every process's rows
            self.num_data = self.shard_plan.n_global
        self._derive_meta()
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

    def _plan_efb(self, conf: Config, raw, sparse: bool
                  ) -> Optional[efb.BundleMeta]:
        """The EFB plan of the train set, or None (reference: _plan_efb,
        basic.py:457-512): ``efb.plan_bundles`` on the used features' bins
        of the 50,000-row plan sample. Monotone-constrained features stay
        out of bundles (the bundle plane has no direction filter), and a
        feature_contri other than all ones turns bundling off (one gain
        multiplier a column cannot hold its members' own; :468-482)."""
        if not conf.enable_bundle or len(self.mappers) < 3:
            return None
        if any(float(v) != 1.0 for v in (conf.feature_contri or [])):
            warning("EFB bundling is disabled because feature_contri is set "
                    "(per-feature gain multipliers cannot apply to merged "
                    "bundle columns)")
            return None
        mc = list(conf.monotone_constraints or [])
        exclude = [u for u, orig in enumerate(self.feature_map)
                   if int(orig) < len(mc) and mc[int(orig)] != 0]
        pod = self._pod_rows_of is not None
        if pod:
            # the one-process draw over every process's rows, kept where
            # it falls in this process's rows; the counts are summed over
            # the ranks, so every rank plans the one-process plan
            # (reference: basic.py:319-333, :486-499)
            from .parallel.multihost import wire_allgather
            row0, n_global = self._pod_rows_of
            idx = efb.plan_sample_index(n_global, conf.data_random_seed)
            idx = (np.arange(raw.shape[0]) if idx is None else
                   idx[(idx >= row0) & (idx < row0 + raw.shape[0])] - row0)
        else:
            idx = efb.plan_sample_index(raw.shape[0], conf.data_random_seed)
        if sparse:
            sample = raw if idx is None else raw[idx].tocsc()
            sample_bins = np.empty((sample.shape[0], len(self.mappers)),
                                   dtype=np.uint8)
            for k, j in enumerate(self.feature_map):
                bin_sparse_column(self.mappers[k], sample, int(j),
                                  sample_bins[:, k])
        else:
            sample = raw if idx is None else raw[idx]
            sample_bins = np.stack(
                [m.values_to_bins(sample[:, j]).astype(np.uint8)
                 for m, j in zip(self.mappers, self.feature_map)], axis=1)
        return efb.plan_bundles(
            sample_bins, self.mappers,
            max_conflict_rate=conf.max_conflict_rate,
            sparse_threshold=conf.sparse_threshold,
            sample_cnt=max(1, sample_bins.shape[0]),
            seed=conf.data_random_seed, exclude=exclude,
            reduce_fn=(None if not pod else lambda a: np.sum(
                wire_allgather(np.ascontiguousarray(a), uniform=True),
                axis=0)))

    def _pod_rows(self, conf: Config, raw, bin_kw: Dict[str, Any],
                  mark) -> List[BinMapper]:
        """This process's place among the processes' rows (a row-count
        gather) and the merged-sketch mappers, the same on every rank and
        bit for bit those of the rows concatenated (reference:
        basic.py:300-316). Sets ``_pod_rows_of`` = (row0, rows of all)."""
        from .parallel import multihost
        p = multihost.process_index()
        counts = multihost.allgather_rows(
            np.array([raw.shape[0]], np.int64), multihost.process_count(),
            p, retries=conf.network_retries,
            name="row-count allgather").reshape(-1)
        self._pod_rows_of = (int(counts[:p].sum()), int(counts.sum()))
        mark("row_count_allgather_s")
        return multihost.find_bin_mappers_pod(
            raw, self._pod_rows_of[1], self._pod_rows_of[0],
            retries=conf.network_retries, phases=self.construct_phases,
            **bin_kw)

    def _pod_plan_check(self, conf: Config, n_local: int) -> None:
        """The process-spanning grid checked against this process's rows
        (``verify_pod_plan``, ``host_row_range``), then the labels,
        weights and init scores of every process gathered (reference:
        basic.py:375-395)."""
        from .parallel import multihost
        plan = self.shard_plan
        multihost.verify_pod_plan(plan)
        row0, n_global = self._pod_rows_of
        lo, hi = multihost.host_row_range(plan)
        if (lo, hi) != (row0, row0 + n_local):
            raise LightGBMError(
                f"multi-process row split mismatch: this process holds "
                f"rows [{row0}, {row0 + n_local}) but the shard plan "
                f"assigns [{lo}, {hi}); load each process's rows with "
                "parallel.multihost.host_row_range / load_file_shard")
        for attr in ("label_np", "weight_np", "init_score_np"):
            v = getattr(self, attr)
            if v is not None:
                setattr(self, attr, multihost.allgather_rows(
                    np.asarray(v, np.float32).reshape(n_local, -1),
                    n_global, row0, retries=conf.network_retries,
                    name=f"{attr[:-3]} allgather").reshape(
                        (-1,) + np.shape(v)[1:]))

    def _refuse_pod(self, what: str) -> None:
        """A train set over several processes holds this process's bins
        and every process's labels: a row-wise operation on it would mix
        them."""
        if self._pod_rows_of is not None:
            raise LightGBMError(f"{what} is not supported on a Dataset "
                                "spanning processes (num_machines > 1)")

    def _plan_shards(self, conf: Config, n_rows: int) -> None:
        """The row-shard plan of ``num_shards`` and ``feature_shards``
        (``parallel/mesh.py``), or None on one shard. Across processes
        ``num_shards`` counts the grid's shards (0: every process's local
        devices) and the plan is this process's block of it."""
        from .parallel.mesh import (device_count, plan_row_sharding,
                                    resolve_feature_shards,
                                    resolve_num_shards)
        kind = self.device.type
        if self._pod_rows_of is not None:
            from .parallel import multihost
            nproc = multihost.process_count()
            fs_req = int(conf.feature_shards or 0)
            ns = int(conf.num_shards or 0) or nproc * max(
                1, device_count(kind) // max(1, fs_req))
            fs = resolve_feature_shards(fs_req, len(self.column_bins()[0]),
                                        ns // nproc, kind)
            self.shard_plan = multihost.plan_pod_sharding(
                self._pod_rows_of[1], ns, multihost.process_index(), nproc,
                axis_name=conf.mesh_axis, feature_shards=fs, kind=kind)
            p = self.shard_plan
            info(f"process-spanning ingest: shards [{p.shard0}, "
                 f"{p.shard0 + p.num_shards}) of {p.global_shards} x "
                 f"{p.rows_per_shard} rows, rows [{p.row0}, "
                 f"{p.row0 + p.n_rows}) of {p.global_rows}")
            return
        ns = resolve_num_shards(int(conf.num_shards or 0), kind)
        fs = resolve_feature_shards(int(conf.feature_shards or 0),
                                    len(self.column_bins()[0]), ns, kind)
        self.shard_plan = plan_row_sharding(
            int(n_rows), ns, axis_name=conf.mesh_axis, feature_shards=fs,
            kind=kind)
        if self.shard_plan is not None:
            p = self.shard_plan
            info(f"row-sharded ingest: {p.num_shards} shards x "
                 f"{p.rows_per_shard} rows (pad {p.pad_rows}, "
                 f"feature_shards {p.feature_shards})")

    def _encode(self, raw, sparse: bool, conf: Config,
                phases: Dict[str, Any]) -> None:
        """Set the uint8 [N, F] bins on the device: one column a used
        feature, or the EFB plan's columns (encoded straight from the CSC
        columns for sparse input; for dense input streamed through the
        chunked pipeline of ``ingest.py`` at ``ingest_chunk_rows`` rows a
        chunk and ``encode_threads`` host threads, binned and bundled on
        the device). Under a row-shard plan the dense ingest commits each
        shard's block on its device (the plan the recovery ladder ended
        with is adopted) and ``bins`` is their real rows on the Dataset's
        device; sparse bins are split into the blocks."""
        meta = self.bundle_meta
        if sparse:
            if meta is not None:
                self.bins = efb.encode_sparse(raw, self.mappers,
                                              self.feature_map, meta,
                                              self.device)
            else:
                self.bins = bin_data_sparse(raw, self.mappers,
                                            self.feature_map, self.device)
            self._set_shards(self.shard_plan)
            return
        from .ingest import stream_with_recovery
        bins, plan, _ = stream_with_recovery(
            raw, self.mappers, list(self.feature_map), meta, self.device,
            chunk_rows=conf.ingest_chunk_rows,
            encode_threads=conf.encode_threads, phases=phases,
            policy=conf.on_device_fault, shard_plan=self.shard_plan)
        if plan is None:
            self.bins = bins
            self._set_shards(None)
        else:
            self.bins = plan.gather(bins, self.device)
            self._set_shards(plan, bins)

    def column_bins(self) -> Tuple[np.ndarray, np.ndarray]:
        """Bins and missing bin (-1: none) of each column of ``bins``,
        known once the mappers and the EFB plan are (reference:
        _derive_meta, basic.py:435-455): a bundle column has its plan's
        bins and no missing bin."""
        meta = self.bundle_meta
        if meta is None:
            return (np.array([m.num_bins for m in self.mappers]),
                    np.array([m.na_bin for m in self.mappers]))
        return (np.asarray(meta.num_bins),
                np.array([self.mappers[mem[0][0]].na_bin if len(mem) == 1
                          else -1 for mem in meta.members]))

    def _derive_meta(self) -> None:
        """The columns' bin counts and missing bins on the device."""
        num_bins, na = self.column_bins()
        self._max_num_bins = int(num_bins.max()) if len(num_bins) else 1
        self.na_bin_dev = torch.as_tensor(
            np.where(na < 0, _NO_NA_BIN, na).astype(np.int32),
            device=self.device)
        self.num_bins_dev = torch.as_tensor(num_bins.astype(np.int32),
                                            device=self.device)

    def feature_names(self) -> List[str]:
        return list(self._names)

    # ---- derived Datasets ----
    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation Dataset binned with this one's mappers (reference:
        basic.py:624)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params)

    def _constructed_like(self, params: Optional[Dict]) -> "Dataset":
        """A constructed Dataset with this one's mappers, plan, names and
        device, and no rows yet."""
        ds = Dataset(None, params={**self.params, **(params or {})},
                     free_raw_data=self.free_raw_data)
        for name in ("mappers", "feature_map", "_names", "bundle_meta",
                     "pandas_categorical", "device", "num_features_raw",
                     "_max_num_bins", "na_bin_dev", "num_bins_dev",
                     "feature_name", "categorical_feature"):
            setattr(ds, name, getattr(self, name))
        ds._constructed = True
        return ds

    def subset(self, used_indices, params: Optional[Dict] = None
               ) -> "Dataset":
        """The rows ``used_indices`` of this constructed Dataset, sharing
        its bin mappers and EFB plan, so that binning happens once
        (reference: basic.py:629-688): the rows of ``bins`` and ``bins_T``
        are gathered on the device, with the label, weight and init score.
        Query groups survive when the rows cover whole queries in order;
        otherwise they are dropped with a warning."""
        self.construct()
        self._refuse_pod("subset")
        idx = np.asarray(used_indices, dtype=np.int64).reshape(-1)
        ds = self._constructed_like(params)
        ds.reference = self
        idx_dev = torch.as_tensor(idx, device=self.device)
        ds.bins = self.bins.index_select(0, idx_dev)
        ds._bins_T = self.bins_T.index_select(1, idx_dev)
        ds.num_data = int(idx.shape[0])
        for name in ("label", "weight"):
            arr = getattr(self, f"{name}_np")
            if arr is not None:
                setattr(ds, f"{name}_np", arr[idx])
                setattr(ds, name, getattr(self, name).index_select(0,
                                                                   idx_dev))
        if self.group is not None:
            bounds = np.cumsum(self.group)
            qid = np.searchsorted(bounds, idx, side="right")
            counts = np.bincount(qid, minlength=len(self.group))
            whole = np.all((counts == 0) | (counts == self.group))
            ordered = len(idx) < 2 or bool(np.all(np.diff(idx) > 0))
            if whole and ordered:
                ds.group = self.group[counts > 0].copy()
            else:
                warning("Dataset.subset on grouped (ranking) data drops the "
                        "group boundaries unless rows cover whole queries "
                        "in order; re-set group on the subset if needed")
        if self.init_score_np is not None:
            isc, n = self.init_score_np, self.num_data
            if isc.ndim == 1 and isc.size != n and isc.size % max(n, 1) == 0:
                # a flat [N * K] init score, row-major by row
                isc = isc.reshape(n, -1)[idx].reshape(-1)
            else:
                isc = isc[idx]
            ds.init_score_np = isc
            ds.init_score = torch.as_tensor(isc, device=self.device)
        return ds

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s columns to this Dataset (reference:
        basic.py:942-1007): both constructed with the same rows; both bin
        layouts are concatenated on the device, the EFB plans merged
        (``efb.merge_bundle_meta``), and feature_contri and the monotone
        constraints padded with their neutral values. Labels, weights and
        groups stay this Dataset's."""
        if not self._constructed or not other._constructed:
            raise LightGBMError("Both source and target Datasets must be "
                                "constructed before adding features")
        if other.num_data != self.num_data:
            raise LightGBMError("Cannot add features from other Dataset with "
                                "a different number of rows")
        if self.shard_plan is not None or other.shard_plan is not None:
            raise LightGBMError("add_features_from does not support "
                                "row-sharded Datasets (construct with "
                                "num_shards=1 first)")
        if self.bundle_meta is not None or other.bundle_meta is not None:
            a = self.bundle_meta or efb.identity_meta(self.mappers)
            b = other.bundle_meta or efb.identity_meta(other.mappers)
            self.bundle_meta = efb.merge_bundle_meta(a, b, len(self.mappers))
        na, nb = self.num_features_raw, other.num_features_raw
        self.feature_map = np.concatenate(
            [np.asarray(self.feature_map, dtype=np.int64),
             np.asarray(other.feature_map, dtype=np.int64) + na]).astype(
                 np.int32)
        self.mappers = list(self.mappers) + list(other.mappers)
        self._bins_T = torch.cat([self.bins_T, other.bins_T], dim=0)
        self.bins = torch.cat([self.bins, other.bins], dim=1)
        self._derive_meta()
        self._names = list(self._names) + list(other._names)
        for key, aliases, get, default, cast in (
                ("feature_contri", ("feature_contrib", "fc", "fp",
                                    "feature_penalty"),
                 Dataset.get_feature_penalty, 1.0, float),
                ("monotone_constraints", ("mc", "monotone_constraint"),
                 Dataset.get_monotone_constraints, 0, int)):
            va, vb = get(self), get(other)
            if va is None and vb is None:
                continue
            merged = (list(va) if va is not None else [default] * na) + \
                (list(vb) if vb is not None else [default] * nb)
            # drop the aliases, or a stale spelling wins over the key
            for alias in aliases:
                self.params.pop(alias, None)
            self.params[key] = [cast(v) for v in merged]
        self.num_features_raw = na + nb
        return self

    def append(self, data, label=None, weight=None, group=None,
               init_score=None, max_rows: Optional[int] = None
               ) -> "Dataset":
        """Append rows to a constructed Dataset under its frozen binning
        (reference: basic.py:690-880): the mappers, feature map and EFB
        plan of the construct bin the new rows, on the device, through the
        ingest pipeline (``ingest.stream_with_recovery``), so values out of
        range clip to the edge bins, NaN takes the missing bin and unseen
        categories bin 0, as in a ``reference=`` construct. Labels and
        weights grow on the device, query sizes and init scores on the
        host.

        ``max_rows`` (default: the ``online_max_rows`` parameter; 0 or
        None: unbounded) keeps the newest ``max_rows`` rows, a FIFO window;
        training on it equals training on a ``reference=`` construct of
        the same rows. Grouped data refuses a window (it would split a
        query), sparse rows are refused. The ``dataset_append`` fault point
        fires once the rows are binned and before anything changes in
        place, so a failed append leaves the Dataset as it was.

        A trainer or Booster built before an append keeps training on the
        rows it was built on; build a new one (``train(init_model=...)``)
        after appending. The construct's kernel prewarm is dropped. A
        row-sharded Dataset re-plans its sharding for the grown total over
        the same shard count and re-splits its rows onto the new grid
        (reference: basic.py:813-827); ``num_data`` never counts padding."""
        from .ingest import last_stats, stream_with_recovery
        from .utils import faults
        self.construct()
        self._refuse_pod("append")
        if _is_sparse(data):
            raise LightGBMError("Dataset.append does not support sparse "
                                "input; densify the appended rows")
        conf = params_to_config(self.params)
        raw = _to_numpy_2d(data, self.pandas_categorical)
        n_new = int(raw.shape[0])
        if n_new == 0:
            return self
        if self.num_features_raw and raw.shape[1] != self.num_features_raw:
            raise LightGBMError(
                f"Dataset.append: appended rows have {raw.shape[1]} features,"
                f" dataset was constructed with {self.num_features_raw}")
        new = {name: None if v is None else
               np.asarray(v, dtype=np.float32).reshape(-1)
               for name, v in (("label", label), ("weight", weight))}
        for name, have in (("label", self.label_np is not None),
                           ("weight", self.weight_np is not None)):
            got = new[name]
            if have and got is None:
                raise LightGBMError(f"Dataset.append: dataset has {name} "
                                    "but appended rows do not")
            if not have and got is not None:
                raise LightGBMError(f"Dataset.append: appended rows carry "
                                    f"{name} but the dataset has none")
            if got is not None and len(got) != n_new:
                raise LightGBMError(f"Dataset.append: {name} has {len(got)} "
                                    f"entries for {n_new} appended rows")
        if self.group is not None and group is None:
            raise LightGBMError("Dataset.append: dataset has group "
                                "boundaries; appended rows must supply their "
                                "own group")
        g_new = None
        if group is not None:
            g_new = np.asarray(group, dtype=np.int64).reshape(-1)
            if int(g_new.sum()) != n_new:
                raise LightGBMError(f"Dataset.append: group sums to "
                                    f"{int(g_new.sum())} but {n_new} rows "
                                    "were appended")
        old_n = int(self.num_data)
        isc = None
        if self.init_score_np is not None or init_score is not None:
            if self.init_score_np is None or init_score is None:
                raise LightGBMError("Dataset.append: init_score must be "
                                    "supplied on both the dataset and the "
                                    "appended rows, or neither")
            old_isc = self.init_score_np
            isc_new = np.asarray(init_score, dtype=np.float32)
            # [N], [N, K] or a flat [N * K] (row-major by row)
            k = old_isc.size // max(old_n, 1)
            if old_isc.size != old_n * k or isc_new.size != n_new * k:
                raise LightGBMError(f"Dataset.append: init_score size "
                                    f"{isc_new.size} does not match {n_new} "
                                    f"rows x {k} classes")
            isc = (old_isc.reshape(old_n, k), isc_new.reshape(n_new, k))
        cap = int(max_rows) if max_rows is not None else \
            int(conf.online_max_rows)
        if cap > 0 and (self.group is not None or group is not None):
            raise LightGBMError("Dataset.append: online_max_rows eviction is "
                                "not supported on grouped (ranking) data — a "
                                "FIFO row window would split query groups")
        t0 = time.perf_counter()
        new_dev, _, _ = stream_with_recovery(
            raw, self.mappers, list(self.feature_map), self.bundle_meta,
            self.device, chunk_rows=conf.ingest_chunk_rows,
            encode_threads=conf.encode_threads, policy=conf.on_device_fault)
        chunks = int(last_stats().get("chunks", 0))
        # the FIFO window: one global row offset splits the kept old rows
        # from the kept new ones
        n_total = old_n + n_new
        evicted = keep_from = new_from = 0
        if cap > 0 and n_total > cap:
            evicted = n_total - cap
            keep_from = min(evicted, old_n)
            new_from = evicted - keep_from
            n_total = cap
        bins = torch.cat([self.bins[keep_from:old_n], new_dev[new_from:]])
        # the crash window of the kill-and-replay drill: the rows are binned
        # on the device and nothing has changed in place yet
        faults.fault_point("dataset_append")
        self.bins = bins
        self._bins_T = None
        self._prewarm = None
        old_plan = self.shard_plan
        resharded = False
        if old_plan is not None:
            # same shard count, grown row total: every row's owner moves
            from .parallel.mesh import plan_row_sharding
            self._set_shards(plan_row_sharding(
                n_total, old_plan.num_shards, axis_name=old_plan.axis_name,
                kind=self.device.type))
            resharded = self.shard_plan is not None
        for name in ("label", "weight"):
            arr = new[name]
            if arr is None:
                continue
            setattr(self, f"{name}_np", np.concatenate(
                [getattr(self, f"{name}_np")[keep_from:], arr[new_from:]]))
            setattr(self, name, torch.cat(
                [getattr(self, name)[keep_from:old_n],
                 torch.as_tensor(arr[new_from:], device=self.device)]))
        if g_new is not None:
            self.group = (g_new if self.group is None
                          else np.concatenate([self.group, g_new]))
        if isc is not None:
            shape = self.init_score_np.shape[1:]
            self.init_score_np = np.concatenate(
                [isc[0][keep_from:], isc[1][new_from:]]).reshape(
                    (-1,) + shape)
            self.init_score = torch.as_tensor(self.init_score_np,
                                              device=self.device)
        self.num_data = n_total
        if obs.enabled():
            obs.emit("dataset_append", rows=n_new, total_rows=n_total,
                     chunks=chunks, duration_s=time.perf_counter() - t0,
                     num_shards=(self.shard_plan.num_shards
                                 if self.shard_plan is not None else 1),
                     resharded=resharded, evicted=int(evicted))
        return self

    # ---- the binned Dataset on disk ----
    _BIN_MAGIC = "lightgbm_tpu_torch_dataset_v1"

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned Dataset, so that training again skips binning
        (reference: basic.py:567-597, which pickles its own classes): one
        numpy ``.npz`` archive of the bins, the label, weight, groups, init
        score and the EFB plan's arrays, and a JSON header of the mappers,
        feature map, names, parameters and plan members. Nothing in it is
        pickled."""
        self.construct()
        self._refuse_pod("save_binary")
        arrays = {"bins": self.bins.cpu().numpy()}
        for name in ("label_np", "weight_np", "group", "init_score_np"):
            val = getattr(self, name)
            if val is not None:
                arrays[name] = np.asarray(val)
        meta = self.bundle_meta
        if meta is not None:
            for k in ("default_bin", "pos_feat", "pos_bin", "range_start",
                      "range_end", "prefix_end", "incl_default", "valid",
                      "is_bundle", "num_bins"):
                arrays[f"efb_{k}"] = np.asarray(getattr(meta, k))
        header = {
            "magic": self._BIN_MAGIC,
            "mappers": [{k: (v.tolist() if isinstance(v, np.ndarray)
                             else v) for k, v in dataclasses.asdict(m).items()}
                        for m in self.mappers],
            "feature_map": np.asarray(self.feature_map).tolist(),
            "names": list(self._names),
            "num_features_raw": self.num_features_raw,
            "params": {k: v for k, v in self.params.items()
                       if isinstance(v, (str, int, float, bool, list))},
            "pandas_categorical": self.pandas_categorical,
            "efb_members": None if meta is None else meta.members,
        }
        arrays["header"] = np.frombuffer(
            json.dumps(header, default=_json_scalar).encode(), np.uint8)
        atomic_io.atomic_write_with(filename,
                                    lambda fh: np.savez(fh, **arrays))
        return self

    @staticmethod
    def load_binary(filename: str, params: Optional[Dict] = None
                    ) -> "Dataset":
        """A Dataset from ``save_binary``'s file, on the device that
        ``params`` (over the saved ones) ask for. The reference package's
        binary files are pickles of its own classes, which would import
        it: they are refused."""
        with open(filename, "rb") as fh:
            zipped = fh.read(4) == b"PK\x03\x04"
        header = None
        if zipped:
            with np.load(filename, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
            if "header" in arrays:
                header = json.loads(arrays.pop("header").tobytes().decode())
        if header is None or header.get("magic") != Dataset._BIN_MAGIC:
            raise LightGBMError(
                f"{filename} is not a lightgbm_tpu_torch binary Dataset "
                "(the reference package's binary files, pickles of its "
                "classes, cannot be read; construct from the raw data, or "
                "carry the reference's mappers over with "
                "convert.mappers_from_reference)")
        ds = Dataset(None, params={**header["params"], **(params or {})})
        conf = params_to_config(ds.params)
        check_slice(conf)
        ds.device = resolve_device(conf)
        ds.mappers = [BinMapper(**{
            k: (np.asarray(v, dtype=np.float64) if k == "upper_bounds"
                else np.asarray(v, dtype=np.int64) if k == "cat_values"
                else v) for k, v in m.items()}) for m in header["mappers"]]
        ds.feature_map = np.asarray(header["feature_map"], dtype=np.int32)
        ds._names = list(header["names"])
        ds.num_features_raw = int(header["num_features_raw"])
        ds.pandas_categorical = header["pandas_categorical"]
        if header["efb_members"] is not None:
            ds.bundle_meta = efb.BundleMeta(
                members=[[tuple(int(v) for v in t) for t in mem]
                         for mem in header["efb_members"]],
                **{k: arrays.pop(f"efb_{k}") for k in (
                    "default_bin", "pos_feat", "pos_bin", "range_start",
                    "range_end", "prefix_end", "incl_default", "valid",
                    "is_bundle", "num_bins")})
        bins = arrays.pop("bins")
        ds.num_data = int(bins.shape[0])
        ds.bins = torch.as_tensor(bins, device=ds.device)
        ds._derive_meta()
        ds.label_np = arrays.get("label_np")
        ds.weight_np = arrays.get("weight_np")
        ds.set_group(arrays.get("group"))
        ds.init_score_np = arrays.get("init_score_np")
        for name in ("label", "weight", "init_score"):
            arr = getattr(ds, f"{name}_np")
            if arr is not None:
                setattr(ds, name, torch.as_tensor(arr, device=ds.device))
        ds._constructed = True
        return ds

    # ---- fields ----
    def get_label(self) -> Optional[np.ndarray]:
        return self.label_np

    def get_weight(self) -> Optional[np.ndarray]:
        return self.weight_np

    def set_label(self, label) -> "Dataset":
        """The label, on the device too once constructed (reference:
        basic.py:899)."""
        self.label_np = None if label is None else \
            np.asarray(label, dtype=np.float32).reshape(-1)
        if self._constructed:
            self.label = None if label is None else torch.as_tensor(
                self.label_np, device=self.device)
        return self

    def set_weight(self, weight) -> "Dataset":
        """Row weights (None: none), on the device too once constructed
        (reference: basic.py:903)."""
        self.weight_np = None if weight is None else \
            np.asarray(weight, dtype=np.float32).reshape(-1)
        if self._constructed:
            self.weight = None if weight is None else torch.as_tensor(
                self.weight_np, device=self.device)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        """Init scores, [N] or [N, K] (None: none; reference:
        basic.py:911)."""
        self.init_score_np = None if init_score is None else \
            np.asarray(init_score, dtype=np.float32)
        if self._constructed:
            self.init_score = None if init_score is None else \
                torch.as_tensor(self.init_score_np, device=self.device)
        return self

    def get_group(self) -> Optional[np.ndarray]:
        return self.group

    def set_group(self, group) -> "Dataset":
        self.group = None if group is None else \
            np.asarray(group, dtype=np.int64).reshape(-1)
        return self

    @property
    def group(self) -> Optional[np.ndarray]:
        """The query sizes; setting them drops the kept query grid."""
        return self._group

    @group.setter
    def group(self, group: Optional[np.ndarray]) -> None:
        self._group = group
        self._query_grid: Optional[QueryGrid] = None

    def query_grid(self, device: torch.device) -> Optional[QueryGrid]:
        """The ranking metrics' grid of the queries on ``device`` (None
        without groups): built at the first call, kept until the groups
        are set again."""
        if self._group is None:
            return None
        if self._query_grid is None or self._query_grid.device != device:
            self._query_grid = QueryGrid(self._group, device)
        return self._query_grid

    def get_init_score(self) -> Optional[np.ndarray]:
        return self.init_score_np

    def get_feature_penalty(self) -> Optional[np.ndarray]:
        """The feature_contri (feature_penalty) parameter as f64, or None
        (reference: basic.py:917-922)."""
        v = params_to_config(self.params).feature_contri
        return np.asarray(v, dtype=np.float64) if v else None

    def get_monotone_constraints(self) -> Optional[np.ndarray]:
        """The monotone_constraints parameter as int8, or None (reference:
        basic.py:924-928)."""
        v = params_to_config(self.params).monotone_constraints
        return np.asarray(v, dtype=np.int8) if v else None


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
        # telemetry knobs given to a Booster (predict-only workflows never
        # reach engine.train): only an explicit param reconfigures, so that
        # a Booster of defaults does not switch off what another entry
        # point enabled (basic.py:1039-1046)
        if any(canonical_name(str(k)) in ("telemetry", "metrics_out")
               for k in self.params):
            obs.configure_from_config(self.config)
        self._gbdt: Optional[GBDT] = None
        self.trees: List[Tree] = []
        self._loaded_meta: Dict[str, Any] = {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.train_set: Optional[Dataset] = None
        self._attr: Dict[str, str] = {}
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
        if train_set._constructed:
            # the binning parameters can no longer apply; the reference
            # warns on a mismatched max_bin, comparing the effective
            # (alias-resolved, defaulted) values (basic.py:1072-1083)
            mb_b = params_to_config(self.params or {}).max_bin
            mb_d = params_to_config(train_set.params or {}).max_bin
            if mb_d != mb_b:
                warning(f"Dataset was constructed before max_bin={mb_b} "
                        f"could apply (effective max_bin={mb_d}); pass "
                        "params to Dataset() or let Booster construct it")
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
        trainer = TRAINERS[boosting_kind(conf.boosting)]
        self._gbdt = trainer(conf, train_set, objective, metrics)
        self.objective = objective

    def add_valid(self, data: Dataset, name: str) -> None:
        data.construct()
        self._gbdt.add_valid(data, name)

    def update(self, train_set: Optional[Dataset] = None,
               fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration; True when no further split was found.

        ``train_set`` is accepted for LightGBM's signature and, as in the
        reference, not used: the Booster trains on the Dataset it was
        built with. ``fobj(score, train_set) -> (grad, hess)`` is called
        with the raw training score as a numpy array, [N] or [N, K], and
        may return [N] / [N, K] arrays or row-major flat ones of N * K
        values (reference: Booster.update, basic.py:1100-1117)."""
        gb = self._gbdt
        if fobj is None:
            return gb.train_one_iter()
        with span("sync.fobj_score"):
            score = gb.train_score.cpu().numpy().copy()
        grad, hess = fobj(score, gb.train_set)
        shape = tuple(gb.train_score.shape)
        grad = np.asarray(grad, dtype=np.float32)
        hess = np.asarray(hess, dtype=np.float32)
        for what, a in (("grad", grad), ("hess", hess)):
            if a.size != gb.train_score.numel():
                raise LightGBMError(f"fobj returned {a.size} {what} values "
                                    f"for a score of shape {shape}")
        # the non-finite guard, on the host before the quantizer
        grad, hess, skip = gb.guard_gradients(grad, hess)
        if skip:
            return gb.skip_one_iter()
        gh = []
        for a in (grad, hess):
            # a blocking copy from the host: it waits for the stream
            with span("sync.fobj_grad"):
                gh.append(torch.as_tensor(a.reshape(shape), device=gb.device))
        return gb.train_one_iter(*gh)

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and take their scores off the
        train and valid scores (reference: basic.py:1119,
        models/gbdt.py:1601-1643)."""
        self._gbdt.rollback_one_iter()
        return self

    def raw_train_score(self) -> np.ndarray:
        """The raw training score, [N] or [N, K] (reference:
        basic.py:1136)."""
        return self._gbdt.train_score.cpu().numpy()

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

    @property
    def pandas_categorical(self) -> Optional[List]:
        """The category lists of the training DataFrame's category columns
        (reference: Booster.pandas_categorical, basic.py:1164-1170), which
        map a DataFrame's categories to the training codes."""
        if self.train_set is not None:
            return self.train_set.pandas_categorical
        return self._loaded_meta.get("pandas_categorical")

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, data_has_header: bool = False,
                **kwargs) -> np.ndarray:
        """Predictions on raw features [N, F] (a numpy array, a scipy
        sparse matrix, a DataFrame or a data file's path) as a numpy array:
        f64 scores (transformed by the objective unless raw_score), [N] or,
        with K trees an iteration, [N, K]; [N, T] leaf indices with
        pred_leaf; or with pred_contrib the TreeSHAP contributions
        [N, K (F + 1)], each class's F features then its expected value
        (``io/shap.py``, on the host), a scipy CSR matrix for sparse input
        (reference: basic.py:1172-1220). A file is parsed as the CLI parses
        it (``io/parser.py``; ``data_has_header``), and its first column is
        taken as a label only when the file has more columns than the
        model has features. Sparse rows are densified 64 MB of f64 at a
        time. Other keyword arguments are accepted and ignored, as in the
        reference."""
        if isinstance(data, (str, os.PathLike)):
            from .io.parser import detect_format, load_file
            kind, _ = detect_format(str(data), skip_header=data_has_header)
            pf = load_file(str(data), header=data_has_header,
                           num_features_hint=self.num_feature())
            x = pf.X
            nf = self.num_feature()
            if (kind != "libsvm" and pf.label is not None and nf
                    and x.shape[1] < nf):
                # column 0 was taken as a label, but the file is not wider
                # than the model: it has no label column
                x = np.column_stack([pf.label, x])
            data = x
        if _is_sparse(data):
            csr = data.tocsr()
            chunk = max(1, (64 << 20) // max(1, 8 * csr.shape[1]))
            outs = [self.predict(csr[i:i + chunk].toarray(), num_iteration,
                                 raw_score, pred_leaf, pred_contrib)
                    for i in range(0, max(csr.shape[0], 1), chunk)]
            if pred_contrib:
                from scipy import sparse as sp
                return sp.vstack([sp.csr_matrix(o) for o in outs]).tocsr()
            return np.concatenate(outs, axis=0)
        trees = self._host_trees()
        k = self.num_model_per_iteration()
        if num_iteration is None:
            num_iteration = self._default_num_iteration()
        if num_iteration > 0:
            trees = trees[:num_iteration * k]
        x_np = _to_numpy_2d(data, self.pandas_categorical)
        nf = self.num_feature()
        if nf and x_np.shape[1] != nf:
            raise LightGBMError(f"The number of features in data "
                                f"({x_np.shape[1]}) is not the same as it "
                                f"was in training data ({nf})")
        if pred_contrib:
            from .io.shap import tree_shap_ensemble
            return tree_shap_ensemble(np.asarray(x_np, np.float64), trees, k,
                                      np.zeros(k))
        # the cached serving engine (serving.py): the tables stay on the
        # device across calls; ops/predict.predict_raw / predict_leaf are
        # its plain versions
        return self._predict_engine_for(trees, x_np.shape[1], k).predict(
            x_np, raw_score=raw_score, pred_leaf=pred_leaf)

    def _predict_engine_for(self, trees: List[Tree], n_features: int,
                            k: int):
        """The PredictEngine of the current tree list, cached; rebuilt when
        the list holds another tree at any position: another count (the
        reference's key, _predict_engine_for, basic.py:1256-1276), or the
        same count after a rollback and an update, a shuffle or a
        reload."""
        from .serving import PredictEngine
        engine = getattr(self, "_predict_engine", None)
        if engine is None or len(engine.trees) != len(trees) or any(
                a is not b for a, b in zip(engine.trees, trees)):
            reason = "new" if engine is None else "invalidated"
            engine = PredictEngine(trees, n_features, k,
                                   self.average_output(),
                                   objective=self._objective_for_predict(),
                                   upload_reason=reason,
                                   device=self._device())
            self._predict_engine = engine
            if obs.enabled():
                obs.METRICS.counter("predict_engine_cache",
                                    "engine cache lookups",
                                    outcome="miss").inc()
        elif obs.enabled():
            obs.METRICS.counter("predict_engine_cache",
                                "engine cache lookups", outcome="hit").inc()
        return engine

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
              weight=None, group=None, **kwargs) -> "Booster":
        """A new Booster with this model's tree structures and leaf values
        refit to new data, rows as ``predict`` takes them (reference:
        Booster.refit, basic.py:1318-1362, which densifies no sparse rows):
        the rows' leaves from ``predict(pred_leaf=True)``; per tree, the
        gradients of the model's objective at the score of the trees
        refit so far, on the port's device; their leaf sums on the host in
        f64, the regularized leaf outputs ``ops/split.leaf_output`` in f32
        times the tree's shrinkage, blended as ``decay * old + (1 - decay)
        * new``. Other keyword arguments (LightGBM's ``dataset_params``,
        ...) are accepted and unused, as in the reference."""
        conf = params_to_config(self.params)
        decay = conf.refit_decay_rate if decay_rate is None else decay_rate
        new_b = Booster(model_str=self.model_to_string(), params=self.params)
        trees = new_b._host_trees()
        if not trees:
            raise LightGBMError("Cannot refit an empty model")
        x = (data if _is_sparse(data)
             else _to_numpy_2d(data, self.pandas_categorical))
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
        """Write the model text crash-safely (a temporary file, fsync and
        rename: ``utils/atomic_io.py``), so no reader sees half a model."""
        atomic_io.atomic_write_text(
            filename, self.model_to_string(num_iteration, start_iteration))
        return self

    def _load_model_string(self, s: str) -> None:
        meta, trees = model_text.parse_model_text(s)
        self._loaded_meta = meta
        self.trees = trees
        self.best_iteration = -1

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict:
        """The model as a dict of nested tree nodes (reference:
        basic.py:1390-1398; the reference takes start_iteration and
        ignores it)."""
        trees = self._host_trees()
        if num_iteration is None:
            num_iteration = self._default_num_iteration()
        if num_iteration and num_iteration > 0:
            trees = trees[:num_iteration * self.num_model_per_iteration()]
        return model_text.dump_model_json(self, trees)

    # ---- introspection ----
    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Each raw feature's number of splits (int64) or their summed gain
        (f64), over every tree (reference: basic.py:1414-1432)."""
        nf = self.num_feature()
        out = np.zeros(nf)
        for t in self._host_trees():
            for i in range(t.num_leaves - 1):
                f = int(t.split_feature[i])
                if f < nf:
                    out[f] += 1 if importance_type == "split" \
                        else t.split_gain[i]
        return out.astype(np.int64) if importance_type == "split" else out

    def attr(self, key: str) -> Optional[str]:
        """A string attribute, or None (reference: basic.py:1440)."""
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """Set string attributes; None deletes one (reference:
        basic.py:1445)."""
        for key, value in kwargs.items():
            if value is None:
                self._attr.pop(key, None)
            elif not isinstance(value, str):
                raise ValueError("Only string values are accepted")
            else:
                self._attr[key] = value
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """One leaf's output (reference: basic.py:1457)."""
        trees = self._host_trees()
        if not 0 <= tree_id < len(trees):
            raise LightGBMError(f"tree_id {tree_id} out of range "
                                f"[0, {len(trees)})")
        t = trees[tree_id]
        if not 0 <= leaf_id < t.num_leaves:
            raise LightGBMError(f"leaf_id {leaf_id} out of range "
                                f"[0, {t.num_leaves})")
        return float(t.leaf_value[leaf_id])

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """The histogram of one feature's split thresholds (reference:
        basic.py:1468-1504): ``bins`` None takes one bin a distinct
        threshold, and an int with ``xgboost_style`` at most that many;
        xgboost_style returns the nonzero (upper edge, count) rows, as a
        DataFrame when pandas is installed. A categorical feature is
        fatal."""
        names = self.feature_name()
        if isinstance(feature, str):
            if feature not in names:
                raise LightGBMError(f"Unknown feature name {feature!r}")
            fidx = names.index(feature)
        else:
            fidx = int(feature)
        values: List[float] = []
        for t in self._host_trees():
            for i in range(t.num_leaves - 1):
                if int(t.split_feature[i]) != fidx:
                    continue
                if bool(t.is_cat_node[i]):
                    raise LightGBMError("Cannot compute split value "
                                        "histogram for the categorical "
                                        "feature")
                values.append(float(t.threshold_real[i]))
        if bins is None or (isinstance(bins, (int, np.integer))
                            and xgboost_style):
            n_unique = len(np.unique(values))
            bins = max(min(n_unique, bins) if bins is not None else n_unique,
                       1)
        hist, edges = np.histogram(values, bins=bins)
        if not xgboost_style:
            return hist, edges
        ret = np.column_stack((edges[1:], hist))
        ret = ret[ret[:, 1] > 0]
        try:
            import pandas as pd
        except ImportError:
            return ret
        return pd.DataFrame(ret, columns=["SplitValue", "Count"])

    def trees_to_dataframe(self):
        """One row a node of every tree (reference: basic.py:1506-1570, the
        reference's columns and "<tree>-S<split>" / "<tree>-L<leaf>" node
        indices). Needs pandas, imported here."""
        import pandas as pd
        if self.num_trees() == 0:
            raise LightGBMError("There are no trees in this Booster and thus "
                                "nothing to parse")
        model = self.dump_model()
        feature_names = model.get("feature_names") or None
        rows: List[Dict[str, Any]] = []

        def node_index(tree_index, node):
            if "split_index" in node:
                return f"{tree_index}-S{node['split_index']}"
            return f"{tree_index}-L{node.get('leaf_index', 0)}"

        def rec(node, tree_index, depth, parent):
            row = dict.fromkeys((
                "left_child", "right_child", "split_feature", "split_gain",
                "threshold", "decision_type", "missing_direction",
                "missing_type", "value", "weight", "count"))
            row.update(tree_index=tree_index, node_depth=depth,
                       node_index=node_index(tree_index, node),
                       parent_index=parent)
            if "split_index" in node:
                sf = node["split_feature"]
                row.update(
                    left_child=node_index(tree_index, node["left_child"]),
                    right_child=node_index(tree_index, node["right_child"]),
                    split_feature=feature_names[sf] if feature_names else sf,
                    split_gain=node["split_gain"],
                    threshold=node["threshold"],
                    decision_type=node["decision_type"],
                    missing_direction=("left" if node["default_left"]
                                       else "right"),
                    missing_type=node["missing_type"],
                    value=node["internal_value"],
                    weight=node["internal_weight"],
                    count=node["internal_count"])
                rows.append(row)
                rec(node["left_child"], tree_index, depth + 1,
                    row["node_index"])
                rec(node["right_child"], tree_index, depth + 1,
                    row["node_index"])
            else:
                row.update(value=node["leaf_value"],
                           weight=node.get("leaf_weight"),
                           count=node.get("leaf_count"))
                rows.append(row)

        for ti in model["tree_info"]:
            rec(ti["tree_structure"], ti["tree_index"], 1, None)
        columns = ["tree_index", "node_depth", "node_index", "left_child",
                   "right_child", "parent_index", "split_feature",
                   "split_gain", "threshold", "decision_type",
                   "missing_direction", "missing_type", "value", "weight",
                   "count"]
        return pd.DataFrame(rows, columns=columns)

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute whole iterations (blocks of K trees) in [start, end)
        with RandomState(17) (reference: basic.py:1611-1642); a training
        Booster's device trees follow, so that training goes on in the new
        order."""
        trees = self._host_trees()
        k = max(self.num_model_per_iteration(), 1)
        total = len(trees) // k
        start = max(0, start_iteration)
        end = total if end_iteration <= 0 else min(total, end_iteration)
        perm = np.arange(total)
        if end > start:
            sub = perm[start:end].copy()
            np.random.RandomState(17).shuffle(sub)
            perm[start:end] = sub

        def reorder(lst):
            return [lst[it * k + j] for it in perm for j in range(k)]
        if self._gbdt is not None:
            self._gbdt.models_host = reorder(self._gbdt.models_host)
            self._gbdt.models_dev = reorder(self._gbdt.models_dev)
            self.trees = self._gbdt.models_host
        else:
            self.trees = reorder(trees)
        return self

    # ---- pickling and copies: the whole model, as model text ----
    def __getstate__(self) -> Dict[str, Any]:
        """The whole model's text (every tree, not best_iteration's) with
        the parameters, best iteration and score, attributes, valid set
        names and pandas categories (reference: basic.py:1572-1586)."""
        return {
            "params": self.params, "best_iteration": self.best_iteration,
            "best_score": self.best_score, "attr": dict(self._attr),
            "name_valid_sets": (list(self._gbdt.valid_names)
                                if self._gbdt is not None else []),
            "pandas_categorical": self.pandas_categorical,
            "model_str": (self.model_to_string(num_iteration=-1)
                          if self.num_trees() else None)}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(params=state.get("params"),
                      model_str=state.get("model_str"))
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = state.get("best_score", {})
        self._attr = dict(state.get("attr", {}))
        self.name_valid_sets = list(state.get("name_valid_sets", []))
        pc = state.get("pandas_categorical")
        if pc is not None:
            self._loaded_meta["pandas_categorical"] = pc

    def __copy__(self) -> "Booster":
        return self.__deepcopy__(None)

    def __deepcopy__(self, _memodict) -> "Booster":
        """A Booster of the whole model's text (reference:
        basic.py:1599-1609)."""
        b = Booster(params=copy.deepcopy(self.params),
                    model_str=(self.model_to_string(num_iteration=-1)
                               if self.num_trees() else None))
        b.best_iteration = self.best_iteration
        b.best_score = copy.deepcopy(self.best_score)
        b._attr = dict(self._attr)
        return b
