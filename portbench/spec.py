"""Where the benchmark finds each piece, by the name ``BENCHMARK.json``
gives it. Each kind of file lives in a directory of its own under the
benchmark's folder, so that a later change adds a file and an entry and
edits none:

- a configuration: the ``file`` its entry in ``BENCHMARK.json`` names
  (``configs/<config>.json``); its family's plain reference and arithmetic,
  ``reference/<family>.py`` (``reference/__init__.py``);
- a traffic mix: ``traffic/<traffic>.json``, read by the general driver
  it names, ``drivers/<driver>.py``;
- a per-layer metric: its reader ``metrics/<metric>.py``, a ``read(run)``
  that returns a number or None;
- a cell's correctness limits: ``limits/<workload>.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent


class Bench:
    """``BENCHMARK.json`` at ``root`` and the benchmark's folder ``home``."""

    def __init__(self, root: Path, home: Path = HERE):
        self.root, self.home = Path(root), Path(home)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key} has no entry {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"]).read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.home / "limits" / f"{workload}.json").read_text())

    def driver(self, mix: dict):
        return importlib.import_module(f"{self.home.name}.drivers.{mix['driver']}")

    def _applies(self, metric: dict, workload: str) -> bool:
        return workload in metric.get("workloads", [workload])

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m, workload)]

    def per_layer(self, workload: str) -> List[dict]:
        """A per-layer metric applies where its ``workloads`` list the cell,
        or, without the key, wherever the metric it moves is reported."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{self.home.name}_metric_{metric.replace('.', '_').replace('-', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

