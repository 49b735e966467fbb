"""What one run of one cell knows: the manifest's entries for the cell,
found by name, and the record its loop fills in for the metric readers.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
and a traffic mix. Each is a file of its own, found by name:

  ``bench/configs/<file>``          the configuration's file (the
                                    manifest's ``file``)
  ``bench/traffic/<traffic>.json``  the mix: ``kind`` names the loop
                                    (``bench/<kind>.py``), the rest are
                                    its parameters
  ``bench/limits/<cell>.json``      the limit of each number compared
  ``bench/metrics/<metric>.py``     a per-layer metric's reader

so a later cell, configuration, mix or metric is new files and new
entries, and no edit.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the mix's file
    limits: dict          # {number: limit}
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the checkout at ``root``."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = root / "bench"
    return Cell(
        name=name, chips=w["chips"],
        config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read(record)`` function of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Record:
    """What a run measured, for the readers. Times in seconds."""
    kind: str                   # the mix's loop: "train" | "serve"
    model: dict                 # the configuration's model sizes
    traffic: dict
    peak: dict                  # the card's row of ``flops.PEAKS``
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)
    steps: int = 0              # trainer steps in the window
    requests: list = field(default_factory=list)   # served, in the window
    rounds: list = field(default_factory=list)     # (slots, padded, lens)
    n_params: int = 0
    trace: object = None        # devtrace.Trace of the traced sub-window
    correct: bool = False
    checks: dict = field(default_factory=dict)     # {number: (value, limit)}
    notes: dict = field(default_factory=dict)
