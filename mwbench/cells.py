"""What `BENCHMARK.json` says about one cell, resolved into files by name:
the configuration's file, the traffic file `traffic/<traffic>.json`, a
reader `metrics/<name>.py` for each per-layer metric, and for a traffic
kind other than the generator's own a loop `kinds/<kind>.py`. A cell, a
configuration, a traffic mix, a traffic kind or a metric is added by adding
its file and its entry; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list
    root: pathlib.Path

    def module(self, folder: str, name: str):
        """The module `mwbench/<folder>/<name>.py` of the cell's checkout."""
        path = self.root / "mwbench" / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"mwbench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The `read(ctx)` function of a per-layer metric."""
        return self.module("metrics", metric).read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root=None) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` (root: the checkout)."""
    root = pathlib.Path(root) if root is not None else HERE.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "mwbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic_name=w["traffic"], traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                root=root)


def yardstick(name: str):
    """A data file of `yardstick/` (the frozen counts and the peaks)."""
    return json.loads((HERE / "yardstick" / name).read_text())
