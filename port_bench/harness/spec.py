"""What a cell is, read from data: BENCHMARK.json at the root of the
checkout names the cell's configuration and traffic; the configuration's
file (port_bench/configs/<name>.json), the traffic's
(port_bench/traffic/<name>.json), the cell's limits
(port_bench/limits/<workload>.json), the traffic's entry
(port_bench/entries/<entry>.py) and each per-layer metric's reader
(port_bench/metrics/<metric>.py) are found by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(bench: dict, key: str, name: str) -> dict:
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")


def load_cell(workload: str, root: Path = ROOT,
              bench: dict | None = None) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    wl = find(bench, "workloads", workload)
    conf = find(bench, "configs", wl["config"])
    config = json.loads((root / conf["file"]).read_text())
    here = root / BENCH_DIR.name
    traffic = json.loads((here / "traffic" / f"{wl['traffic']}.json").read_text())
    limits_file = here / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text())["limits"]

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and applies(m)]
    return Cell(wl, config, traffic, limits, e2e, per_layer)


def _module(kind: str, name: str, root: Path):
    path = root / BENCH_DIR.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The `read(ctx)` function of port_bench/metrics/<name>.py."""
    return _module("metrics", name, root).read


def entry_module(name: str, root: Path = ROOT):
    """The module of the traffic entry `name`, port_bench/entries/<name>.py:
    its `METRIC` (the end-to-end metric it reports) and its `Entry`."""
    return _module("entries", name, root)


def _literal(cls, value):
    """A dataclass instance from a JSON object, lists back to tuples and
    nested dataclass fields built from their own objects."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in value:
            raise KeyError(f"{cls.__name__}.{f.name} is not in the configuration")
        v = value[f.name]
        if isinstance(v, dict):
            v = _literal(type(getattr(cls(), f.name)), v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    extra = set(value) - set(kw)
    if extra:
        raise KeyError(f"{cls.__name__} has no fields {sorted(extra)}")
    return cls(**kw)


def env_config(config_cls, config: dict):
    """The configuration's Go1Config, field by field (every field given)."""
    return _literal(config_cls, config["env"])


def ppo_config(config_cls, config: dict, traffic: dict):
    """The configuration's PPOConfig; the traffic may set num_envs."""
    cfg = _literal(config_cls, config["ppo"])
    if traffic.get("num_envs"):
        cfg.num_envs = int(traffic["num_envs"])
    return cfg
