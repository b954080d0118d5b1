"""``BENCHMARK.json`` keeps to the benchmark's contract: names, units, keys,
limits, and a file for every name the harness looks up."""
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [w["config"] for w in BENCH["workloads"]]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [m["name"] for m in METRICS]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("unit", sorted({m["unit"] for m in METRICS}))
def test_unit_characters(unit):
    assert UNIT.match(unit), unit


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys_and_text():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in METRICS:
        assert m["better"] in ("lower", "higher")
    for word in BENCH["command"]:
        assert TEXT.match(word)


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)]
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert any(cell in m.get("workloads", cells) and m["moves"] in names
                   for m in BENCH["per_layer"])


def test_every_name_finds_its_file():
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir()
    assert (ROOT / BENCH["command"][1]).is_file()
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("perfbench/")
        conf = json.loads(path.read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert conf["check"] and all(v > 0 for v in conf["check"].values())
    for w in BENCH["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
    for m in METRICS:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_check_budget_fits_the_full_benchmark():
    """A full check of 24 cells at ``run_seconds`` fits its 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
