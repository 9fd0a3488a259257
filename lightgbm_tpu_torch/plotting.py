"""Plotting utilities.

Port of ``lightgbm_tpu/plotting.py`` (the reference python package's
plotting module, python-package/lightgbm/plotting.py): feature importance,
split-value histograms, metric curves and tree digraphs over this
package's ``Booster`` and ``LGBMModel``. matplotlib (and graphviz for the
digraphs) is imported inside each function, so importing this module
needs neither.
"""
from __future__ import annotations

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel


def _check_not_tuple_of_2_elements(obj, obj_name="obj"):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _to_booster(booster) -> Booster:
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel")


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    dpi=None, grid=True, precision=3, **kwargs):
    """Bar chart of feature importances (reference: plotting.py plot_importance)."""
    import matplotlib.pyplot as plt

    bst = _to_booster(booster)
    importance = bst.feature_importance(importance_type)
    feature_name = bst.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")
    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain" else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None, width_coef=0.8,
                               xlim=None, ylim=None,
                               title="Split value histogram for feature with @index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid=True, **kwargs):
    """Histogram of split threshold values for one feature (reference:
    plotting.py plot_split_value_histogram)."""
    import matplotlib.pyplot as plt

    bst = _to_booster(booster)
    trees = bst._host_trees()
    names = bst.feature_name()
    if isinstance(feature, str):
        feature = names.index(feature)
    values = []
    for t in trees:
        for i in range(t.num_leaves - 1):
            if int(t.split_feature[i]) == feature:
                values.append(t.threshold_real[i])
    if not values:
        raise ValueError("Cannot plot split value histogram, "
                         f"because feature {feature} was not used in splitting")
    values = np.array(values)
    if bins is None:
        bins = min(len(np.unique(values)), 20) or 1
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    hist, bin_edges = np.histogram(values, bins=bins)
    centres = (bin_edges[:-1] + bin_edges[1:]) / 2
    width = width_coef * (bin_edges[1] - bin_edges[0]) if len(bin_edges) > 1 else 1.0
    ax.bar(centres, hist, align="center", width=width, **kwargs)
    if title:
        title = title.replace("@index/name@", "name" if isinstance(feature, str) else "index")
        title = title.replace("@feature@", str(feature))
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None, xlim=None,
                ylim=None, title="Metric during training", xlabel="Iterations",
                ylabel="auto", figsize=None, dpi=None, grid=True):
    """Metric curves from evals_result (reference: plotting.py plot_metric)."""
    import matplotlib.pyplot as plt

    if isinstance(booster, LGBMModel):
        eval_results = booster.evals_result_
    elif isinstance(booster, dict):
        eval_results = booster
    else:
        raise TypeError("booster must be dict or LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    msg = None
    for name in dataset_names:
        metrics = eval_results[name]
        if metric is None:
            metric = list(metrics.keys())[0]
        results = metrics[metric]
        ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index=0, show_info=None, precision=3,
                        **kwargs):
    """Graphviz digraph of one tree (reference: plotting.py create_tree_digraph)."""
    import graphviz

    bst = _to_booster(booster)
    trees = bst._host_trees()
    if tree_index >= len(trees):
        raise IndexError("tree_index is out of range.")
    t = trees[tree_index]
    names = bst.feature_name()
    show_info = show_info or []
    graph = graphviz.Digraph(**kwargs)

    def add(ptr, parent=None, decision=None):
        if ptr < 0:
            leaf = ~ptr
            name = f"leaf{leaf}"
            label = f"leaf {leaf}: {t.leaf_value[leaf]:.{precision}f}"
            if "leaf_count" in show_info:
                label += f"\ncount: {t.leaf_count[leaf]}"
            if "leaf_weight" in show_info:
                label += f"\nweight: {t.leaf_weight[leaf]:.{precision}f}"
            graph.node(name, label=label)
        else:
            name = f"split{ptr}"
            feat = (names[t.split_feature[ptr]]
                    if t.split_feature[ptr] < len(names) else str(t.split_feature[ptr]))
            label = f"{feat} <= {t.threshold_real[ptr]:.{precision}f}"
            if "split_gain" in show_info:
                label += f"\ngain: {t.split_gain[ptr]:.{precision}f}"
            if "internal_count" in show_info:
                label += f"\ncount: {t.internal_count[ptr]}"
            graph.node(name, label=label, shape="rectangle")
            add(int(t.left_child[ptr]), name, "yes")
            add(int(t.right_child[ptr]), name, "no")
        if parent is not None:
            graph.edge(parent, name, decision)
        return name

    add(0 if t.num_leaves > 1 else ~0)
    return graph


def plot_tree(booster, ax=None, tree_index=0, figsize=None, dpi=None,
              show_info=None, precision=3, **kwargs):
    """Render one tree with matplotlib via graphviz (reference: plotting.py
    plot_tree)."""
    import matplotlib.image as image
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision, **kwargs)
    from io import BytesIO
    s = BytesIO()
    s.write(graph.pipe(format="png"))
    s.seek(0)
    img = image.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
