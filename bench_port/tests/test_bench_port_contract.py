"""``BENCHMARK.json`` against its own rules and against the files the
harness finds by name."""
import json
import re
from pathlib import Path

import pytest

from bench_port import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "bench_port"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head_dim|"
                   r"_dim$|_rank$|expansion|experts_per_tok|num_experts_per)")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {e["name"]: e for e in BENCH["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert (ROOT / cmd[1]).is_file() and cmd[1].startswith("bench_port/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == want, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
    metrics = [e["name"] for s in ("end_to_end", "per_layer")
               for e in BENCH[s]]
    assert len(metrics) == len(set(metrics))


def test_configs_and_their_files():
    for c in BENCH["configs"]:
        assert c["name"] in {w["config"] for w in CELLS.values()}
        assert c["file"].startswith("bench_port/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert key in conf["departures"] and key in conf["published"]
        assert (HERE / "flops" / f"{c['name']}.py").is_file()
        assert (HERE / "reference" / f"{conf['reference']}.py").is_file()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_cells_find_their_files_and_limits():
    pairs = {(w["config"], w["traffic"]) for w in CELLS.values()}
    assert len(pairs) == len(CELLS)
    assert sum(w["chips"] == 4 for w in CELLS.values()) <= max(
        1, len(CELLS) // 4)
    for name, w in CELLS.items():
        assert w["chips"] in (1, 4)
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (HERE / "kinds" / f"{traffic['kind']}.py").is_file()
        spec = harness.load_spec(name, ROOT)
        assert spec.limits, f"{name} has no limits file"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    spec = harness.load_spec(cell, ROOT)
    e2e = [n for n, _ in spec.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    for e in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{e['name']}.py").is_file()
        moved = E2E[e["moves"]]
        for cell in e.get("workloads", list(CELLS)):
            assert cell in CELLS
            assert cell in moved.get("workloads", [cell]), (e["name"], cell)
    layers = {e["layer"] for e in BENCH["per_layer"]}
    assert all(_line(x) for x in layers)


def test_bounds_and_the_check_fits_its_time():
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25
    # a full check with 24 cells: 2 + 14 runs a cell, each allowed
    # run_seconds + 60, 2 x 90 s of compile a cell, 1200 s spare
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
