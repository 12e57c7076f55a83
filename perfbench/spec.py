"""``BENCHMARK.json`` and the files it names, found by name under
``perfbench/``: a configuration in ``configs/<config>.json`` (its input
generator in ``generators/<name>.py``, its reference in
``reference/<name>.py``), a traffic mix in ``traffic/<mix>.json`` (its
loop in ``loops/<loop>.py``), a metric's reader in
``metrics/<metric>.py``, a kernel's frozen count in
``kernels/<kernel>.py``. A later cell, mix, configuration, metric or
kernel is new files and new entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r}; have "
                     f"{[e['name'] for e in entries]}")


def load_json(root: Path, rel: str) -> dict:
    return json.loads((root / rel).read_text())


def config(root: Path, bench: dict, name: str) -> dict:
    return load_json(root, find(bench["configs"], name,
                                "configuration")["file"])


def traffic(root: Path, name: str) -> dict:
    return load_json(root, f"perfbench/traffic/{name}.json")


def load_module(path: Path):
    """Import one file by its path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    return load_module(root / "perfbench" / "metrics" / f"{metric}.py")


def kernel(root: Path, name: str):
    return load_module(root / "perfbench" / "kernels" / f"{name}.py")


def reference(root: Path, name: str):
    return load_module(root / "perfbench" / "reference" / f"{name}.py")


def loop(root: Path, name: str):
    return load_module(root / "perfbench" / "loops" / f"{name}.py").Loop


def generator(root: Path, name: str):
    return load_module(root / "perfbench" / "generators" / f"{name}.py")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
    reports: those that list it, and those with no list whose moved
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out
