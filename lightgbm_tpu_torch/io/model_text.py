"""Model text serialization, reference-format compatible.

Port of ``lightgbm_tpu/io/model_text.py`` ``dump_model_text`` (:36),
``parse_model_text`` (:113), ``dump_model_json`` (:159) and
``model_to_cpp`` (:175): the reference's v3 model file (header, one
block per tree with exact ``tree_sizes``, feature importances, parameters
footer), so models move between the two packages and LightGBM tooling.
A model of K trees an iteration (multiclass) writes ``num_class`` and
``num_tree_per_iteration`` = K and is sliced K trees an iteration; a
loaded model keeps the ``num_class`` of its file. An averaged model (RF)
writes the ``average_output`` line; a model trained on a DataFrame with
category columns writes their categories on the ``pandas_categorical:``
line (:96-127).
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

from ..models.tree import Tree

_VERSION = "v3"


def _objective_string(booster) -> str:
    """The objective line (reference: model_text.py:20-33): the configured
    name, with num_class for the multiclass names, sigmoid for binary and
    multiclassova, and the truncation level for lambdarank."""
    obj = booster._loaded_meta.get("objective") if booster._loaded_meta \
        else None
    if obj:
        return obj
    conf = booster.config
    name = conf.objective
    extras = []
    if name in ("multiclass", "multiclassova", "softmax", "ova", "ovr"):
        extras.append(f"num_class:{conf.num_class}")
    if name in ("binary", "multiclassova"):
        extras.append(f"sigmoid:{conf.sigmoid:g}")
    if name == "lambdarank":
        extras.append("lambdarank_truncation_level:"
                      f"{conf.lambdarank_truncation_level}")
    return " ".join([name] + extras)


def dump_model_text(booster, trees: List[Tree], num_iteration: int = -1,
                    start_iteration: int = 0) -> str:
    k = booster.num_model_per_iteration()
    if num_iteration and num_iteration > 0:
        trees = trees[: num_iteration * k]
    trees = trees[start_iteration * k:]
    names = booster.feature_name()
    if booster.train_set is not None:
        infos = ["none"] * len(names)
        fm = booster.train_set.feature_map
        for used_idx, m in enumerate(booster.train_set.mappers):
            orig = int(fm[used_idx]) if fm is not None else used_idx
            if orig < len(infos):
                infos[orig] = m.to_feature_info()
        max_feature_idx = len(names) - 1
    else:
        infos = booster._loaded_meta.get("feature_infos",
                                         ["none"] * len(names))
        max_feature_idx = int(booster._loaded_meta.get("max_feature_idx",
                                                       len(names) - 1))
    num_class = (booster._loaded_meta or {}).get("num_class",
                                                 booster.config.num_class)
    lines = [
        "tree",
        f"version={_VERSION}",
        f"num_class={num_class}",
        f"num_tree_per_iteration={k}",
        "label_index=0",
        f"max_feature_idx={max_feature_idx}",
        f"objective={_objective_string(booster)}",
        "average_output" if booster.average_output() else None,
        f"feature_names={' '.join(names)}",
        f"feature_infos={' '.join(infos)}",
        "",
    ]
    lines = [ln for ln in lines if ln is not None]
    # reference byte convention (gbdt_model_text.cpp:313-325): each block is
    # "Tree=i\n" + Tree::ToString() + "\n" and tree_sizes is its length
    tree_blocks = [t.to_string(i) + "\n" for i, t in enumerate(trees)]
    lines.insert(len(lines) - 1,
                 f"tree_sizes={' '.join(str(len(b)) for b in tree_blocks)}")
    body = "\n".join(lines) + "".join(tree_blocks) + "end of trees\n"

    imp: Dict[int, int] = {}
    for t in trees:
        for i in range(t.num_leaves - 1):
            f = int(t.split_feature[i])
            imp[f] = imp.get(f, 0) + 1
    body += "\nfeature importances:\n"
    for f, c in sorted(imp.items(), key=lambda kv: (-kv[1], kv[0])):
        nm = names[f] if f < len(names) else f"Column_{f}"
        body += f"{nm}={c}\n"
    body += "\nparameters:\n"
    loaded_block = (booster._loaded_meta or {}).get("parameters_block")
    if loaded_block is not None:
        body += loaded_block
    else:
        for key, val in sorted(booster.params.items()):
            body += f"[{key}: {val}]\n"
    # the training DataFrame's category lists, so that a loaded model
    # maps a frame's categories to the same codes (reference:
    # model_text.py:96-109)
    pc = booster.pandas_categorical
    body += ("end of parameters\n\npandas_categorical:"
             f"{json.dumps(pc, default=_json_default) if pc else 'null'}\n")
    return body


def dump_model_json(booster, trees: List[Tree]) -> Dict:
    """The model as a dict (reference: dump_model_json, :159-172)."""
    names = booster.feature_name()
    return {
        "name": "tree",
        "version": _VERSION,
        "num_class": (booster._loaded_meta or {}).get(
            "num_class", booster.config.num_class),
        "num_tree_per_iteration": booster.num_model_per_iteration(),
        "label_index": 0,
        "max_feature_idx": len(names) - 1,
        "objective": _objective_string(booster),
        "average_output": booster.average_output(),
        "feature_names": names,
        "tree_info": [t.to_json(i) for i, t in enumerate(trees)],
    }


def _json_default(o):
    """numpy scalars among the categories as Python numbers."""
    if hasattr(o, "item"):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")


def parse_model_text(s: str) -> Tuple[Dict, List[Tree]]:
    header, _, rest = s.partition("\nTree=")
    meta: Dict = {}
    if "\nparameters:\n" in s:
        meta["parameters_block"] = s.split("\nparameters:\n", 1)[1].split(
            "end of parameters")[0]
    if "\npandas_categorical:" in s:
        pc_line = s.rsplit("\npandas_categorical:", 1)[1].splitlines()[0]
        try:
            meta["pandas_categorical"] = json.loads(pc_line)
        except ValueError:
            meta["pandas_categorical"] = None
    for line in header.splitlines():
        line = line.strip()
        if not line or line == "tree":
            continue
        if line == "average_output":
            meta["average_output"] = True
            continue
        if "=" in line:
            key, val = line.split("=", 1)
            meta[key] = val
    for key in ("feature_names", "feature_infos"):
        if key in meta:
            meta[key] = meta[key].split(" ")
    for key in ("num_class", "num_tree_per_iteration", "max_feature_idx",
                "label_index"):
        if key in meta:
            meta[key] = int(meta[key])
    trees: List[Tree] = []
    if rest:
        body = ("Tree=" + rest).split("end of trees")[0]
        for b in body.split("\nTree="):
            if not b.strip():
                continue
            if not b.startswith("Tree="):
                b = "Tree=" + b
            trees.append(Tree.from_string(b))
    return meta, trees


def model_to_cpp(booster, trees: List[Tree]) -> str:
    """The whole model as C++ if-else code with a ``Predict(features,
    output)`` entry of raw scores (reference: ModelToIfElse,
    gbdt_model_text.cpp:87; model_text.py:175-208), for the CLI's
    convert_model task."""
    parts = [
        "#include <cmath>",
        "#include <cstdint>",
        "#include <initializer_list>",
        "static inline bool IsLeft(double v, double thr, bool default_left) {",
        "  if (std::isnan(v)) return default_left;",
        "  return v <= thr;",
        "}",
        "static inline bool IsCatLeft(double v, std::initializer_list<int> s) {",
        "  if (std::isnan(v) || v < 0) return false;",
        "  int iv = static_cast<int>(v);",
        "  for (int c : s) if (c == iv) return true;",
        "  return false;",
        "}",
        "",
    ]
    for i, t in enumerate(trees):
        parts.append(t.to_if_else(i))
    k = booster.num_model_per_iteration()
    parts.append("double (*PredictTreePtr[])(const double*) = {")
    parts.append(",\n".join(f"  PredictTree{i}" for i in range(len(trees))))
    parts.append("};")
    parts.append(f"""
void Predict(const double* features, double* output) {{
  for (int k = 0; k < {k}; ++k) output[k] = 0.0;
  for (int i = 0; i < {len(trees)}; ++i) {{
    output[i % {k}] += PredictTreePtr[i](features);
  }}
}}
""")
    return "\n".join(parts)
