#!/usr/bin/env python3
"""``calibrate.py`` for a ranking cell: the port faults it plants are the
HIGGS cells' (``tests/test_gbdt_bench_control.py PORT_FAULTS``) but AUC's
altered metric, and the ranking path's own (``tests/test_gbdt_bench_ranking.py
RANKING_FAULTS``: LambdaRank's ideal DCG over all of a query's documents;
NDCG altered where it is produced, AUC's twin), or those named by
``--faults``.

    python3 gbdt_bench/calibrate_ranking.py [--faults NAME,NAME,...] --
        --workload yahoo_ltr.bin63 --seeds ... --control-seeds ...
        --fault-seeds ... [--seconds S] [--out FILE]

Everything after ``--`` is ``calibrate.py``'s own arguments; its readings
are its lines, each port fault's kind ``fault_port_<name>``.
"""
import argparse
import os
import sys
from typing import Callable, Dict, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_faults(names: Optional[Sequence[str]] = None
                ) -> Dict[str, Callable]:
    """The port faults a ranking cell is read under, or those named."""
    from gbdt_bench.tests import test_gbdt_bench_control as control
    from gbdt_bench.tests import test_gbdt_bench_ranking as ranking
    every = {**control.PORT_FAULTS, **ranking.RANKING_FAULTS}
    if names is None:
        return {k: v for k, v in every.items() if k != "altered_metric"}
    unknown = sorted(set(names) - set(every))
    if unknown:
        raise SystemExit(f"no port fault {unknown}; there are {sorted(every)}")
    return {k: every[k] for k in names}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--faults", default=None,
                    help="port faults to plant, comma separated (all)")
    args = ap.parse_args(argv[:cut])
    sys.path.insert(0, ROOT)
    from gbdt_bench import calibrate
    from gbdt_bench.tests import test_gbdt_bench_control as control
    chosen = port_faults(None if args.faults is None
                         else args.faults.split(","))
    kept = control.PORT_FAULTS
    control.PORT_FAULTS = chosen
    try:
        return calibrate.main(argv[cut + 1:])
    finally:
        control.PORT_FAULTS = kept


if __name__ == "__main__":
    sys.exit(main())
