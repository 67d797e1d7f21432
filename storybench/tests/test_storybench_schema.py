"""`BENCHMARK.json` against the rules of its format: keys, names, units,
chips, the files each entry names, the metrics each cell reports, and the
time a full check takes."""

import json
import re

from storybench import data

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = data.benchmark()


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((data.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (data.ROOT / p).is_dir()
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("storybench/")
        cfg = json.loads((data.ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"] == []
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert (data.HERE / "mixes" / f"{w['traffic']}.json").exists()
        assert (data.HERE / "limits" / f"{w['name']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


def test_metrics_each_cell_reports():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert (data.HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", cells):
            reported = {x["name"] for x in data.metrics_of(BENCH, cell,
                                                           "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in cells:
        e = {x["name"] for x in data.metrics_of(BENCH, cell, "end_to_end")}
        assert "setup_s" in e and len(e) >= 2
        assert data.metrics_of(BENCH, cell, "per_layer")
        for name in e:
            assert (data.HERE / "metrics" / f"{name}.py").exists()


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
