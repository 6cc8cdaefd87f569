"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration's file is ``configs/<config>.json``, the mix's
``traffic/<traffic>.json``, its call pattern ``patterns/<pattern>.py`` and
each metric's reader ``metrics/<metric>.py``.  Adding a cell, a mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def metrics(self, traced: bool) -> list:
        """The metric entries this cell reports in a run with or without a trace."""
        return self.per_layer if traced else self.end_to_end


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict, root: Path = REPO) -> Cell:
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if len(matches) != 1:
        raise KeyError(f"BENCHMARK.json has {len(matches)} cells named {name!r}")
    w = matches[0]
    configs = [c for c in bench["configs"] if c["name"] == w["config"]]
    if len(configs) != 1:
        raise KeyError(f"BENCHMARK.json has {len(configs)} configurations named {w['config']!r}")
    config = json.loads((root / configs[0]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)])


def pattern(name: str):
    """The call pattern module ``patterns/<name>.py``."""
    return importlib.import_module(f"portbench.patterns.{name}")


def metric_reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
