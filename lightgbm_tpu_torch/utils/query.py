"""The query layout of a ranking Dataset's group sizes, shared by the
ranking objectives and metrics."""
from __future__ import annotations

import numpy as np


def query_grid(group: np.ndarray):
    """The [Q, M] row index grid of the queries (M the longest) and its
    mask, on the host."""
    bounds = np.concatenate([[0], np.cumsum(group)])
    m = int(group.max())
    cols = np.arange(m)
    msk = cols[None, :] < np.asarray(group)[:, None]
    idx = np.where(msk, bounds[:-1, None] + cols[None, :], 0).astype(np.int32)
    return idx, msk
