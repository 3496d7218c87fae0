"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; a new mix and a new metric are added by files
alone."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.spec import Bench

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = Bench(ROOT)
SPEC = BENCH.spec
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"][1].startswith("portbench/") and len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys_and_valid_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = []
    for section, want in keys.items():
        for entry in SPEC[section]:
            assert set(entry) - {"workloads"} == want, (section, entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"), entry["name"]))
            for text in ("why", "layer", "source"):
                if text in entry and section in ("configs", "workloads", "per_layer"):
                    assert _line(entry[text]), (entry["name"], text)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in BENCH.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = BENCH.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    entry = BENCH.workload(cell)
    config = BENCH.config(entry["config"])
    mix = BENCH.mix(entry["traffic"])
    assert config["name"] == entry["config"] and mix["name"] == entry["traffic"]
    assert hasattr(BENCH.driver(mix), "Driver")
    assert set(BENCH.limits(cell)) >= {"token_gap"} or set(BENCH.limits(cell)) >= {"loss_gap"}
    for m in BENCH.per_layer(cell):
        assert callable(BENCH.reader(m["name"]))
    ref = ROOT / "portbench" / "reference" / f"{config['reference']}.py"
    assert ref.exists()


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configuration_files(entry):
    path = ROOT / entry["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    config = json.loads(path.read_text())
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    for key in ("deployment", "assumed", "precision", "port", "reference"):
        assert key in config
    files = [e["file"] for e in SPEC["configs"]]
    assert len(files) == len(set(files))


def test_a_mix_a_metric_and_a_family_are_added_by_files_alone(tmp_path):
    """A copy of the checkout's benchmark gains a mix (for the train
    driver), a per-layer metric, and a configuration of a family of its
    own (its reference module, a copy of the dense one under a new name)
    by new files and entries only; traced CPU runs report the metric and
    the new family's prefill is correct."""
    home = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", home, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(home / "reference" / "dense.py", home / "reference" / "dense_copy.py")
    phi3 = next(c for c in spec["configs"] if c["name"] == "phi3-medium-14b")
    config = dict(json.loads((ROOT / phi3["file"]).read_text()), name="phi3-copy",
                  reference="dense_copy")
    (home / "configs" / "phi3-copy.json").write_text(json.dumps(config))
    spec["configs"].append(dict(phi3, name="phi3-copy", file="portbench/configs/phi3-copy.json"))
    spec["workloads"].append({"name": "tiny-copy", "config": "phi3-copy",
                              "traffic": "prefill_2k", "chips": 1, "why": "a test"})
    shutil.copy(home / "limits" / "phi3-prefill2k.json", home / "limits" / "tiny-copy.json")
    for m in spec["per_layer"]:
        if m["name"] == "mfu.prefill":
            m["workloads"].append("tiny-copy")
    mix = json.loads((home / "traffic" / "train_4k.json").read_text())
    mix.update(name="train_tiny", seq_len=32, batch=2)
    (home / "traffic" / "train_tiny.json").write_text(json.dumps(mix))
    (home / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return float(run['units']) if run['kind'] == 'train' else None\n")
    spec["workloads"].append({"name": "tiny-train", "config": "mamba2-2.7b",
                              "traffic": "train_tiny", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "model step",
                              "moves": "train_tokens_per_s", "workloads": ["tiny-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(home / "limits" / "mamba2-train4k.json", home / "limits" / "tiny-train.json")
    script = f"""
import json, sys, time
sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'portbench' / 'tests')!r}]
import torch
from portbench import cell
from portbench.spec import Bench
from tiny import tiny
bench = Bench({str(tmp_path)!r})
config, mix = tiny(bench, "tiny-train")
out = cell.run(bench, "tiny-train", 5, 0.3, True, torch.device("cpu"), time.perf_counter(),
               config=config)
config, mix = tiny(bench, "tiny-copy")
copy = cell.run(bench, "tiny-copy", 5, 0.3, True, torch.device("cpu"), time.perf_counter(),
                config=config, mix=mix)
assert sys.modules["portbench.reference.dense_copy"]
assert copy["correct"] and "mfu.prefill" in copy["metrics"], copy
print(json.dumps(out["metrics"]))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(metrics) == {"steps_seen"} and metrics["steps_seen"]["value"] >= 1
