"""The benchmark's definition as data: ``BENCHMARK.json`` at the root of the
checkout, and the files it names by name under ``portbench/``:

* ``configs/<config>.json``: a configuration (the ``file`` of its entry);
* ``traffic/<traffic>.json``: a traffic mix;
* ``limits/<cell>.json``: the limit of each number the comparison reads;
* ``metrics/<metric>.py``: a metric's reader, ``read(ctx)``;
* ``kernels/<kernel>.py``: a kernel's counted work, ``SYMBOLS``,
  ``work(**shape)`` and ``batch_shapes(batch)``;
* ``datagen/<generator>.py``: the generator a configuration's ``data``
  names, ``make(params, n, d, seed, device)``;
* ``references/<reference>.py``: the plain reference a configuration names.

A new cell, metric or kernel count is a new file and a new entry: nothing
here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent
ROOT = PORTBENCH.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def load_module(path: Path):
    """Import one file of the benchmark by its path."""
    name = "portbench._file_." + re.sub(r"\W", "_", str(path.relative_to(PORTBENCH)))
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def counts() -> dict:
    """Every kernel count file, by kernel name."""
    return {p.stem: load_module(p) for p in sorted((PORTBENCH / "kernels").glob("*.py"))}


def hand_symbols() -> set[str]:
    """The program's own device kernels: every ``__global__`` function
    defined in its CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    found = set()
    for src in sorted(CSRC.glob("*.cu*")):
        found.update(pat.findall(src.read_text()))
    return found


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def reader(self, metric: str):
        return load_module(PORTBENCH / "metrics" / f"{metric}.py")

    def module(self, folder: str, name: str):
        return load_module(PORTBENCH / folder / f"{name}.py")


def _reported(metric: dict, cell: str) -> bool:
    """Whether a cell reports an end-to-end metric: those with a
    ``workloads`` list in the cells it names, the others in every cell."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = read_json(benchmark)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {benchmark.name}; known: {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    reported = {m["name"] for m in e2e}
    # every per-layer metric of what the cell reports is read; a reader that
    # finds nothing to read in this cell returns None and the metric is left out
    layer = [m for m in bench["per_layer"] if m["moves"] in reported]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=read_json(PORTBENCH / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(PORTBENCH / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=layer,
    )
