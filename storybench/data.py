"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root, a workload's configuration (`configs/<config>.json`, the file that
`BENCHMARK.json` names) and traffic mix (`mixes/<traffic>.json`), and each
metric's reader (`metrics/<metric>.py`, a `read(ctx)` that returns a
number, or None where it finds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def files(config: str, traffic: str) -> tuple:
    """(configuration dict, mix dict) by their names: the files
    `configs/<config>.json` and `mixes/<traffic>.json`."""
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    mix = json.loads((HERE / "mixes" / f"{traffic}.json").read_text())
    return cfg, mix


def workload(bench: dict, name: str) -> tuple:
    """(workload entry, configuration dict, mix dict) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, cfg, mix


def metrics_of(bench: dict, name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics a cell reports: those that
    list it, and those without a list whose `moves` metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in reported)]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "storybench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
