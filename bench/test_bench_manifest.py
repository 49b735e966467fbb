"""The manifest (``BENCHMARK.json``) against the benchmark's contract, and
the harness's promise that a cell is files found by name: a new cell,
configuration, mix and per-layer metric are new files and new entries."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from bench.cell import ROOT, load_cell, reader

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expand|d_model|d_ff|experts_per|top_k)")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "-m", "bench.run"]
    assert MANIFEST["paths"] == ["bench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    secs = MANIFEST["run_seconds"]
    assert 1 <= secs <= 51
    assert (2 + 14 * 24) * (secs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:          # a configuration's source
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200
        assert "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_are_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_configuration_has_a_cell_and_its_file():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        for key, published in conf["published"].items():
            assert key in c["reduced"] and conf["model"][key] != published


def test_cells_ask_for_one_chip_or_four():
    chips = [w["chips"] for w in MANIFEST["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_set_up_another_end_to_end_and_a_layer(cell):
    c = load_cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (m["name"], m["moves"])
        assert callable(reader(m["name"]))
    assert c.limits


def test_metrics_of_a_layer_share_its_name():
    layers: dict = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert layers["device_idle_share"] == {"device"}


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """Copy the checkout's benchmark, add a configuration, a mix, a limit
    and a per-layer reader as new files and entries, and load the cell
    through the same loaders: no file the benchmark has is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    conf = json.loads((root / "bench/configs/internlm2-1.8b.json").read_text())
    conf["name"] = "internlm2-1.8b-copy"
    (root / "bench/configs/internlm2-1.8b-copy.json").write_text(
        json.dumps(conf))
    mix = json.loads(
        (root / "bench/traffic/prefill.c32.len512-8192.json").read_text())
    mix["max_new"] = 64
    (root / "bench/traffic/decode.c2.json").write_text(json.dumps(mix))
    (root / "bench/limits/serve.internlm2-1.8b-copy.decode.json").write_text(
        json.dumps({"logit_gap_max": 0.25}))
    (root / "bench/metrics/rounds.serve.py").write_text(
        "def read(rec):\n    return float(len(rec.rounds)) or None\n")
    manifest["configs"].append({"name": "internlm2-1.8b-copy",
                                "source": "https://arxiv.org/abs/2403.17297",
                                "file": "bench/configs/internlm2-1.8b-copy.json",
                                "reduced": [], "why": "a copy"})
    manifest["workloads"].append({"name": "serve.internlm2-1.8b-copy.decode",
                                  "config": "internlm2-1.8b-copy",
                                  "traffic": "decode.c2", "chips": 1,
                                  "why": "a decode mix"})
    manifest["per_layer"].append({"name": "rounds.serve", "unit": "rounds",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "scheduler", "moves":
                                  "prefill_tokens_per_s",
                                  "workloads":
                                  ["serve.internlm2-1.8b-copy.decode"]})
    manifest["end_to_end"] = [
        {**m, "workloads": m["workloads"]
            + ["serve.internlm2-1.8b-copy.decode"]}
        if "prefill_tokens_per_s" == m["name"] else m
        for m in manifest["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = load_cell("serve.internlm2-1.8b-copy.decode", root)
    assert cell.traffic["max_new"] == 64
    assert cell.config["name"] == "internlm2-1.8b-copy"
    assert [m["name"] for m in cell.per_layer] == ["rounds.serve"]
    rec = type("R", (), {"rounds": [(2, 10, [5, 10])]})()
    assert reader("rounds.serve", root)(rec) == 1.0
    assert all(p.read_bytes() == b for p, b in before.items())
