"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each entry points at, and the time a full check would take."""
import json
import re

import pytest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert all(_line(w) for w in MAN["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"])
    assert entry["file"] == f"bench/configs/{entry['name']}.json"
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:        # a cut of scale, never a width
        assert NAME.match(key) and cfg[key] != cfg["published"][key]
        assert key in cfg["why_reduced"]
    for key, value in cfg["published"].items():
        assert key in cfg["reduced"] or cfg.get(key, value) == value
    assert cfg["model"]["precision"] == "float32"


@pytest.mark.parametrize("entry", MAN["workloads"], ids=lambda e: e["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and _line(entry["why"])
    assert entry["config"] in {c["name"] for c in MAN["configs"]}
    assert (BENCH / "traffic" / f"{entry['traffic']}.json").is_file()
    mine = [m["name"] for m in MAN["end_to_end"]
            if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in mine and len(mine) >= 2
    assert any(entry["name"] in m.get("workloads", [entry["name"]])
               for m in MAN["per_layer"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and _line(metric["layer"])
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    moves = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
    # every cell the metric is read in reports the metric it moves
    assert set(metric.get("workloads", [])) <= set(moves.get("workloads",
                                                             cells))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_files_under_paths_have_plain_names():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            rel = f.relative_to(ROOT)
            if ".cache" in rel.parts or "__pycache__" in rel.parts:
                continue
            assert PATH.match(str(rel)), rel
