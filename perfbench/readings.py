"""The readings that the limits of the comparison are set from, in one
process so that set-up is paid once: the program's numbers compared
over many seeds, and the control's (``control.py``) over a few, each a
short window of the cell's own traffic at its own sizes.

    python3 perfbench/readings.py --workload <cell> --seconds 2
        --seeds 11,12,... --control-seeds 21,22,23

Prints one JSON line a run: the side, the seed, the numbers compared and
the rows compared. Not part of the benchmark's runs.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from perfbench import control
    from perfbench.cell import run_cell

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    runs = [("program", s, None) for s in seeds(args.seeds)] + \
        [("control", s, control.substitute(ROOT))
         for s in seeds(args.control_seeds)]
    for side, seed, sub in runs:
        r = run_cell(ROOT, args.workload, seed, args.seconds, False,
                     time.perf_counter(), substitute=sub)
        print(json.dumps({"side": side, "seed": seed,
                          "correct": r["correct"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()},
                          "rows": r["info"]["rows_compared"],
                          "completed": r["info"]["completed"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
