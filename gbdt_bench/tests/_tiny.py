"""A cell of the benchmark cut to a size the CPU tests hold: the
configuration's own parameters and traffic, the cell's own limits, 20,000
train and 4,000 valid rows. ``min_sum_hessian_in_leaf`` shrinks with the
rows, so that it binds a tree no more than at the configuration's size."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gbdt_bench import harness  # noqa: E402

ROWS = {"higgs": {"rows_train": 20000, "rows_valid": 4000},
        "yahoo_ltr": {"rows_train": 6000, "queries_valid": 60,
                      "features": 60, "relevant_features": 10}}


def tiny_cell(name: str = "higgs.bin63") -> "harness.Cell":
    cell = harness.load_cell(ROOT, name)
    rows = ROWS[cell.config["name"]]
    params = dict(cell.config["params"])
    params["min_sum_hessian_in_leaf"] *= (rows["rows_train"]
                                          / cell.config["rows_train"])
    cell.config = {**cell.config, **rows, "params": params}
    return cell
