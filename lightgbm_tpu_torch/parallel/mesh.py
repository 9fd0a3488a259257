"""Device mesh utilities.

Port of ``lightgbm_tpu/parallel/mesh.py``: the row-shard plan
(``RowShardPlan``, :28), the shard-count knobs (``resolve_num_shards``,
:90; ``resolve_feature_shards``, :113), ``plan_row_sharding`` (:140),
``make_mesh`` (:180), ``shard_rows``, ``replicate`` and
``pad_rows_to_devices``. The reference's mesh is a ``jax.sharding.Mesh``
and its collectives are XLA's; here a mesh is an array of
``torch.device`` s, one a shard, and the growers sum the shards' tensors
themselves (``ops/grow.py`` ``_psum`` / ``_hist_allreduce``). A mesh may
name one device more than once: the shards then share it, as the fleet's
replicas share a card (``fleet/replica.py``).

``virtual_devices(n, device)`` is the port's counterpart of XLA's
``--xla_force_host_platform_device_count``: inside it the local device
list is ``n`` copies of ``device``. The tests train on 8 virtual CPU
devices, as the reference's suite does, and ``chip_smoke.py`` on 4 copies
of ``cuda:0``. Auto (``num_shards=0``) shards over every device only when
there is more than one real CUDA device; a virtual list keeps auto at one
shard, as the reference's ``cpu`` platform does.

Across processes (``num_machines > 1``), ``init_distributed`` starts the
``torch.distributed`` group, and a ``RowShardPlan`` describes this
process's block of a grid that spans the processes
(``parallel/multihost.plan_pod_sharding``); the growers then sum each
histogram across the ranks after the local shard sum.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..log import LightGBMError, info, warning

DATA_AXIS = "data"
# the second axis of the optional 2-D (data, feature) mesh: rows stay
# blocked over the data axis and replicated over this one, and each
# histogram sum is split into feature blocks (ops/grow._hist_allreduce)
FEATURE_AXIS = "feature"

_LOCK = threading.Lock()
_VIRTUAL: List[List[torch.device]] = []


@contextlib.contextmanager
def virtual_devices(n: int, device: Union[str, torch.device] = "cpu"
                    ) -> Iterator[List[torch.device]]:
    """Make the local device list ``n`` copies of ``device`` while the
    block runs (nested blocks stack)."""
    if n < 1:
        raise ValueError("virtual_devices: n must be >= 1")
    devs = [torch.device(device)] * int(n)
    with _LOCK:
        _VIRTUAL.append(devs)
    try:
        yield list(devs)
    finally:
        with _LOCK:
            _VIRTUAL.remove(devs)


def _virtual_list() -> Optional[List[torch.device]]:
    with _LOCK:
        return list(_VIRTUAL[-1]) if _VIRTUAL else None


def is_virtual(kind: str = "cpu") -> bool:
    """Whether the local device list of ``kind`` is a virtual one."""
    v = _virtual_list()
    return v is not None and v[0].type == kind


def local_devices(kind: str = "cpu") -> List[torch.device]:
    """The local devices of a device type: the innermost
    ``virtual_devices`` list when it is of that type, else every CUDA
    device, or the one CPU."""
    v = _virtual_list()
    if v is not None and v[0].type == kind:
        return v
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_count(kind: str = "cpu") -> int:
    return len(local_devices(kind))


class Mesh:
    """A 1-D (shards) or 2-D (shards, feature blocks) array of devices
    with its axis names (the reference's ``jax.sharding.Mesh``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        for idx in np.ndindex(arr.shape):
            sub = devices
            for i in idx:
                sub = sub[i]
            arr[idx] = torch.device(sub)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of {arr.ndim} axes named {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"{[str(d) for d in self.devices.flat]})")


@dataclasses.dataclass(frozen=True)
class RowShardPlan:
    """Row partition of an [N, ...] matrix over a 1-D (or 2-D) mesh.

    Pure metadata, so that Dataset.construct can publish it before the
    bins exist and the ingest, the prewarm and the trainer agree on one
    grid. Rows are blocked contiguously: shard ``s`` owns global rows
    ``[s * rows_per_shard, (s + 1) * rows_per_shard)``; the last shard's
    rows past ``n_rows`` are padding, zero bins with zero g, h and count.
    With ``feature_shards > 1`` the mesh is 2-D ``(data, feature)``: rows
    stay blocked over the data axis, the feature axis exists so that the
    histogram sums can be split by feature block."""
    mesh: Mesh
    axis_name: str
    num_shards: int
    n_rows: int            # true (unpadded) row count
    rows_per_shard: int    # ceil(n_rows / num_shards)
    feature_shards: int = 1
    feature_axis: str = FEATURE_AXIS
    # the process-spanning grid (parallel/multihost.py): this process
    # holds global row shards [shard0, shard0 + num_shards) of
    # global_shards and global rows [row0, row0 + n_rows) of global_rows,
    # rows_per_shard being the global grid's; in one process the plan is
    # the whole grid (process_count 1, the globals 0)
    shard0: int = 0
    row0: int = 0
    global_shards: int = 0
    global_rows: int = 0
    process_index: int = 0
    process_count: int = 1

    @property
    def n_global(self) -> int:
        """The rows of the whole grid, every process's."""
        return self.global_rows or self.n_rows

    @property
    def shards_global(self) -> int:
        return self.global_shards or self.num_shards

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a tensor of every process's rows (the
        trainer's row-length state is global in a process-spanning run);
        ``x`` as it is when it already holds this process's rows."""
        if self.process_count > 1 and int(x.shape[0]) == self.global_rows:
            return x[self.row0:self.row0 + self.n_rows]
        return x

    @property
    def n_padded(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def pad_rows(self) -> int:
        return self.n_padded - self.n_rows

    @property
    def devices(self) -> List[torch.device]:
        """One owning device a row shard (the feature-axis leader on a 2-D
        mesh): the ingest commits each row block there and the kernels of
        the shard run there."""
        if self.feature_shards > 1:
            return [self.mesh.devices[s, 0] for s in range(self.num_shards)]
        return list(self.mesh.devices.flat)

    def row_devices(self, s: int) -> List[torch.device]:
        """Every device of row shard ``s``'s mesh row."""
        if self.feature_shards > 1:
            return list(self.mesh.devices[s, :])
        return [self.mesh.devices.flat[s]]

    @property
    def feature_devices(self) -> Tuple[torch.device, ...]:
        """The device that sums each feature block (the first mesh row's),
        or () on a 1-D mesh."""
        if self.feature_shards <= 1:
            return ()
        return tuple(self.mesh.devices[0, :])

    def shard_rows_range(self, s: int) -> Tuple[int, int]:
        """Global [lo, hi) of the real rows of shard ``s`` (hi == lo for
        a shard of padding only)."""
        lo = min(s * self.rows_per_shard, self.n_rows)
        hi = min((s + 1) * self.rows_per_shard, self.n_rows)
        return lo, hi

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The per-shard blocks of a row-major tensor of ``n_rows`` rows:
        ``rows_per_shard`` rows each on the shard's device, the padding
        rows zero. A block that needs no padding and already lies on its
        device is a view of ``x``. A tensor of every process's rows is
        cut to this process's first (``local``)."""
        return _split(self.local(x), self.rows_per_shard, self.devices,
                      self.n_rows)

    def gather(self, parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
        """The real rows of per-shard blocks, concatenated on ``device``."""
        out = []
        for s, p in enumerate(parts):
            lo, hi = self.shard_rows_range(s)
            if hi > lo:
                out.append(p[:hi - lo].to(device))
        if not out:   # a process of padding only
            return parts[0][:0].to(device)
        return torch.cat(out) if len(out) > 1 else out[0]


def _split(x: torch.Tensor, rps: int, devices: Sequence[torch.device],
           n_rows: int) -> List[torch.Tensor]:
    out = []
    for s, dev in enumerate(devices):
        lo, hi = min(s * rps, n_rows), min((s + 1) * rps, n_rows)
        part = x[lo:hi]
        if hi - lo < rps:
            pad = torch.zeros((rps - (hi - lo),) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            part = torch.cat([part, pad])
        out.append(part.to(dev))
    return out


def resolve_num_shards(requested: int, kind: str = "cpu") -> int:
    """The ``num_shards`` knob (0 = auto) as a shard count. Auto shards
    over every device when there is more than one real CUDA device, else
    one; an explicit count larger than the device list is clamped with the
    reference's warning."""
    nd = device_count(kind)
    if requested and requested > 0:
        if requested > nd:
            warning(f"num_shards={requested} exceeds the {nd} available "
                    "devices; clamping")
        return max(1, min(int(requested), nd))
    return nd if (nd > 1 and kind == "cuda" and not is_virtual(kind)) else 1


def resolve_feature_shards(requested: int, num_features: int,
                           num_shards: int, kind: str = "cpu") -> int:
    """The ``feature_shards`` knob (0/1 = off) for a 2-D mesh: clamped to
    the devices that exist (num_shards * feature_shards of them) and then
    down to a divisor of the feature count, with the reference's
    warnings."""
    fs = int(requested or 0)
    if fs <= 1 or num_shards <= 1:
        return 1
    nd = device_count(kind)
    max_fs = max(1, nd // max(1, num_shards))
    if fs > max_fs:
        warning(f"feature_shards={fs} needs {num_shards}x{fs} devices but "
                f"only {nd} exist; clamping to {max_fs}")
        fs = max_fs
    if num_features > 0 and num_features % fs != 0:
        d = fs
        while d > 1 and num_features % d != 0:
            d -= 1
        warning(f"feature_shards={fs} does not divide {num_features} "
                f"features; clamping to divisor {d}")
        fs = d
    return max(1, fs)


def plan_row_sharding(n_rows: int, num_shards: int,
                      axis_name: str = DATA_AXIS, feature_shards: int = 1,
                      kind: str = "cpu") -> Optional[RowShardPlan]:
    """The row-shard plan, or None for one shard (the serial path)."""
    if num_shards <= 1 or n_rows <= 0:
        return None
    feature_shards = max(1, int(feature_shards))
    mesh = make_mesh(num_shards * feature_shards, axis_name=axis_name,
                     feature_shards=feature_shards, kind=kind)
    rps = -(-n_rows // num_shards)   # ceil
    return RowShardPlan(mesh=mesh, axis_name=axis_name,
                        num_shards=int(num_shards), n_rows=int(n_rows),
                        rows_per_shard=int(rps),
                        feature_shards=feature_shards)


def make_mesh(num_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              devices: Optional[Sequence] = None, feature_shards: int = 1,
              feature_axis: str = FEATURE_AXIS, kind: str = "cpu") -> Mesh:
    """A 1-D data-parallel mesh of the first ``num_devices`` local devices
    (or of ``devices``), or 2-D (data, feature) when feature_shards > 1."""
    devs = list(devices) if devices is not None else local_devices(kind)
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(f"a mesh of {num_devices} devices needs that "
                             f"many; {len(devs)} exist")
        devs = devs[:num_devices]
    if feature_shards > 1:
        d = len(devs) // feature_shards
        return Mesh([[devs[i * feature_shards + j]
                      for j in range(feature_shards)] for i in range(d)],
                    (axis_name, feature_axis))
    return Mesh(devs, (axis_name,))


def shard_rows(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """An array split along its leading (row) axis over the mesh's data
    axis: ceil(N / shards) rows a shard on its device, the last shard's
    tail padded with zeros."""
    devs = (list(mesh.devices[:, 0]) if mesh.devices.ndim > 1
            else list(mesh.devices.flat))
    n = int(x.shape[0])
    return _split(x, -(-n // len(devs)), devs, n)


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """One copy of ``x`` on each device of the mesh (the same tensor where
    the device is ``x``'s)."""
    return [x.to(d) for d in mesh.devices.flat]


def pad_rows_to_devices(x: np.ndarray, n_dev: int):
    """Pad the row count to a multiple of the mesh size; returns (padded,
    original N)."""
    n = x.shape[0]
    pad = (-n) % n_dev
    if pad:
        x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    return x, n


# the process group's transport once init_distributed has run: the
# backend, and the device its payloads cross from (the rank's card under
# NCCL, the host under gloo)
DIST = {"backend": "", "device": None, "card": None}


def machine_list(config) -> List[str]:
    """The ``machines`` entries (``host:port``, comma-separated), else the
    lines of ``machine_list_filename`` (``host port`` or ``host:port`` a
    line, ``#`` comments; reference: linkers_socket.cpp:80)."""
    machines = str(config.machines or "")
    if not machines and config.machine_list_filename:
        with open(config.machine_list_filename) as fh:
            entries = [ln.split("#", 1)[0].strip() for ln in fh]
        machines = ",".join(":".join(e.split()) for e in entries if e)
    return [m.strip() for m in machines.split(",") if m.strip()]


def choose_backend(config) -> Tuple[str, Optional[torch.device]]:
    """(backend, card) of this rank: NCCL when every rank of this host
    owns a distinct card, gloo when ranks share a card or train on the
    CPU. The rank's card is its local rank (``LOCAL_RANK``, else
    ``RANK``) modulo the visible cards; the ranks of this host are
    ``LOCAL_WORLD_SIZE``, else ``num_machines``."""
    if str(config.device_type).lower() not in ("cuda", "gpu"):
        return "gloo", None
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("device_type='cuda' but no CUDA device is "
                           "available; pass device_type='cpu'")
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", env.get("RANK", "0")))
    local_world = int(env.get("LOCAL_WORLD_SIZE", config.num_machines))
    card = torch.device("cuda", local_rank % cards)
    return ("nccl" if local_world <= cards else "gloo"), card


def init_distributed(config) -> bool:
    """The multi-process bootstrap (reference: :218-283; Network::Init,
    network.cpp:30): ``torch.distributed.init_process_group`` over
    ``tcp://`` the first ``machines`` entry (an entry without a port
    listens on ``local_listen_port``; no list: torch's ``env://``), with
    ``world_size=num_machines``, the rank from the ``RANK`` environment
    variable and a timeout of ``time_out`` minutes. The ``dist_init``
    fault point and transient failures retry with backoff,
    ``network_retries`` attempts. Idempotent; True when running
    multi-process. A failure of either backend raises."""
    if config.num_machines <= 1:
        return False
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ:
        raise LightGBMError("num_machines > 1 needs this process's rank in "
                            "the RANK environment variable")
    machines = machine_list(config)
    if machines:
        coord = machines[0]
        if ":" not in coord:
            coord = f"{coord}:{config.local_listen_port}"
        init_method = f"tcp://{coord}"
    else:
        init_method = "env://"
    backend, card = choose_backend(config)
    kwargs = dict(backend=backend, init_method=init_method,
                  world_size=int(config.num_machines),
                  rank=int(os.environ["RANK"]))
    if config.time_out and config.time_out > 0:
        kwargs["timeout"] = datetime.timedelta(minutes=int(config.time_out))
    from ..utils import faults
    from ..utils.retry import call_with_backoff

    def _init_once():
        faults.fault_point("dist_init")
        dist.init_process_group(**kwargs)

    call_with_backoff(_init_once, attempts=max(1, int(config.network_retries)),
                      base_delay=0.5, name="torch.distributed init")
    if card is not None:
        torch.cuda.set_device(card)
    DIST.update(backend=backend, card=card,
                device=card if backend == "nccl" else torch.device("cpu"))
    from .. import obs
    obs.METRICS.gauge("lgbmtpu_dist_world_size",
                      "processes of the torch.distributed group",
                      backend=backend).set(dist.get_world_size())
    info(f"torch.distributed initialized: rank {dist.get_rank()} of "
         f"{dist.get_world_size()} over {backend} ({init_method}"
         f"{', card ' + str(card) if card is not None else ', CPU'})")
    return True
