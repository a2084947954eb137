"""The benchmark finds its parts by name, a new cell is new files, and
every name, unit and text keeps to the contract's characters."""

import json
import re
import shutil

import pytest

from phybench import spec
from phybench.run import Readings

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
STREAM = json.loads((ROOT / "phybench/tests/stream_cell.json").read_text())
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_config_traffic_and_metrics(cell):
    c = spec.load_cell(cell)
    assert c.config["limits"] and c.traffic["loop"] in ("batch", "stream")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (cell, m["name"])


@pytest.mark.parametrize("metric", PER_LAYER + [m["name"] for m in STREAM["per_layer"]])
def test_each_reader_matches_its_entry(metric):
    entry = next(m for m in BENCH["per_layer"] + STREAM["per_layer"] if m["name"] == metric)
    mod = spec.load_reader(metric)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (entry["unit"], entry["layer"], entry["moves"])
    # A run with nothing to read gives nothing, never 0.
    assert mod.read(Readings(loop="batch", issue_s=[])) is None
    assert mod.read(Readings(loop="stream", issue_s=[])) is None


def test_names_units_and_texts_keep_to_the_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]] + PER_LAYER
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME.match(n), n
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for group, need in keys.items():
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got)), group
        for x in BENCH[group]:
            extra = {"workloads"} if group == "end_to_end" else set()
            assert need <= set(x) <= need | extra, (group, x["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    texts = ([w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    for t in texts:
        assert TEXT.match(t), t
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("phybench/")
    assert len(json.dumps(BENCH)) < 64 * 1024
    for f in (ROOT / "phybench").rglob("*"):
        rel = f.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or ".cache" in rel:
            continue
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_a_new_cell_is_new_files(tmp_path):
    """A copy of the benchmark with a new configuration, mix, metric and
    cell added as files and entries, no existing file edited, resolves."""
    shutil.copytree(ROOT / "phybench", tmp_path / "phybench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "phybench").rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / "phybench/configs/nr20_siso_4ue.json").read_text())
    cfg["ul_modulation"] = "qam16"
    (tmp_path / "phybench/configs/nr20_siso_qam16.json").write_text(json.dumps(cfg))
    (tmp_path / "phybench/traffic/batch64.json").write_text(json.dumps(
        {"loop": "batch", "slots": 64, "snr_db": 20.0, "warmup_steps": 2,
         "profile_steps": 4}))
    (tmp_path / "phybench/metrics/issue_steps.py").write_text(
        'UNIT = "steps"\nLAYER = "host issue"\nMOVES = "x_real_time"\n\n\n'
        'def read(r):\n    return float(len(r.issue_s)) or None\n')
    bench["configs"].append({"name": "nr20_siso_qam16", "source": "a test",
                             "file": "phybench/configs/nr20_siso_qam16.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "nr20_qam16_batch64", "config": "nr20_siso_qam16",
                               "traffic": "batch64", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("nr20_qam16_batch64")
    bench["per_layer"].append({"name": "issue_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "host issue",
                               "moves": "x_real_time", "workloads": ["nr20_qam16_batch64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "phybench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())

    c = spec.load_cell("nr20_qam16_batch64", tmp_path)
    assert c.config["ul_modulation"] == "qam16" and c.traffic["slots"] == 64
    assert [m["name"] for m in c.end_to_end] == ["x_real_time", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["issue_steps"]
    reader = spec.load_reader("issue_steps", tmp_path)
    assert reader.read(Readings(loop="batch", issue_s=[0.1, 0.2])) == 2.0
    # The cells already there are as they were.
    assert spec.load_cell(CELLS[0], tmp_path).per_layer == spec.load_cell(CELLS[0]).per_layer


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")
