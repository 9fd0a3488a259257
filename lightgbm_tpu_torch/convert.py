"""Carry state across from the reference package without importing it.

- ``mappers_from_reference``: the reference's BinMapper fields, as plain
  dicts of numbers and numpy arrays (``dataclasses.asdict`` of its
  mappers), become the port's ``BinMapper``s;
- ``booster_from_model_text``: the reference's ``model_to_string()``
  becomes a port ``Booster`` that predicts the same model;
- ``resume_state_from_reference``: the reference's snapshot sidecar (its
  ``get_resume_state`` arrays and meta, as numpy and JSON) becomes the
  port's, for ``GBDT.set_resume_state`` or a port snapshot directory.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .basic import Booster
from .binning import BinMapper

_MAPPER_FIELDS = tuple(f.name for f in fields(BinMapper))


def mappers_from_reference(mapper_dicts: Sequence[Mapping[str, Any]]
                           ) -> List[BinMapper]:
    """Port BinMappers from the reference's mapper fields."""
    out = []
    for d in mapper_dicts:
        kw = {k: d[k] for k in _MAPPER_FIELDS if k in d}
        kw["upper_bounds"] = np.asarray(kw.get("upper_bounds", [np.inf]),
                                        dtype=np.float64)
        kw["cat_values"] = np.asarray(kw.get("cat_values", []),
                                      dtype=np.int64)
        out.append(BinMapper(**kw))
    return out


def booster_from_model_text(text: str,
                            params: Optional[Dict[str, Any]] = None
                            ) -> Booster:
    """A port Booster holding the model of a reference model text."""
    return Booster(params=params, model_str=text)


def resume_state_from_reference(arrays: Mapping[str, np.ndarray],
                                meta: Mapping[str, Any]
                                ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """The port's resume state from the reference's snapshot sidecar.

    Both packages write the same keys for the same quantities (the f32
    train score, the f64 init scores, the threefry bag key as two uint32
    words, the bag mask, each RandomState's MT19937 state, the stacked
    tree arrays ``trees_<field>`` with ``num_leaves`` one a tree, DART's
    tree weights, the four CEGB fields with the [1, 1] placeholder of an
    absent lazy bitset), so those pass as they are, in the port's
    dtypes."""
    out: Dict[str, np.ndarray] = {}
    dtypes = {"split_feature": np.int32, "threshold_bin": np.int32,
              "left_child": np.int32, "right_child": np.int32,
              "num_leaves": np.int32, "default_left": np.bool_,
              "is_cat": np.bool_, "cat_mask": np.bool_}
    for key, val in arrays.items():
        val = np.asarray(val)
        if key.startswith("trees_"):
            val = val.astype(dtypes.get(key[len("trees_"):], np.float32))
        elif key in ("train_score", "bag_mask"):
            val = val.astype(np.float32)
        elif key == "bag_key":
            val = val.astype(np.uint32)
        elif key.startswith("cegb_"):
            val = val.astype(np.float32 if key.endswith("_pen")
                             else np.bool_)
        out[key] = val
    return out, dict(meta)
