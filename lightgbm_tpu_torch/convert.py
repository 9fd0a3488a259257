"""Carry state across from the reference package without importing it.

- ``mappers_from_reference``: the reference's BinMapper fields, as plain
  dicts of numbers and numpy arrays (``dataclasses.asdict`` of its
  mappers), become the port's ``BinMapper``s;
- ``booster_from_model_text``: the reference's ``model_to_string()``
  becomes a port ``Booster`` that predicts the same model.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, List, Mapping, Optional, Sequence

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
