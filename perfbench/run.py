"""The benchmark's command: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout of the repository. The cells, their
configurations, traffic mixes and metrics are in ``BENCHMARK.json`` and
the files it names under ``perfbench/``. With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from ``torch.profiler`` over the window. The last line of
standard output is the result, one JSON object; the numbers compared for
``correct`` close standard error and the result. Without enough CUDA
cards, or where the process has loaded JAX or the JAX package, the run
exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # the kernels' library builds into, and loads from, a fixed directory
    # inside the checkout, so that only a checkout's first run builds it
    os.environ["SUPRASNN_TORCH_CACHE_DIR"] = str(
        ROOT / "src" / "repro_torch" / "kernels" / "_build")
    from perfbench import spec
    cell = spec.find(spec.load_benchmark(ROOT)["workloads"], args.workload,
                     "workload")
    import torch
    stamps = [("import_torch", time.perf_counter())]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    torch.cuda.init()
    stamps.append(("cuda_init", time.perf_counter()))
    from perfbench.cell import forbidden_modules, run_cell
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, stamps=stamps)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
