"""The port's rule battery. Importing this package registers every rule
with ``core._REGISTRY``; each module holds one hazard class (or, for
pod_safety, the family of cross-process ones)."""
from . import (atomic_write, collectives, device_errors,  # noqa: F401
               dtype_drift, host_sync, lock_order, nonfinite, params,
               pod_safety, shared_state, telemetry)
