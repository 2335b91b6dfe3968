"""Find a cell's files by name: the manifest (``BENCHMARK.json`` in the
working directory, the root of a checkout) and the files under this
folder. Nothing here imports the program or torch."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def manifest(root: Path) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> Dict[str, Any]:
    with open(HERE / kind / f"{_checked(name)}.json") as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    return _json("configs", name)


def traffic(name: str) -> Dict[str, Any]:
    return _json("traffic", name)


def cell_file(name: str) -> Dict[str, Any]:
    return _json("workloads", name)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{_checked(name)}.py"
    mod_name = f"uvbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(root: Path, name: str) -> Dict[str, Any]:
    """The manifest's entry for cell ``name``, with its configuration,
    traffic and settings files, and the metrics it reports: with
    ``trace`` 0 the end-to-end metrics, with 1 the per-layer ones, each
    where it lists the cell or lists no cells."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(metrics: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [x for x in metrics if "workloads" not in x or name in x["workloads"]]

    return {
        "name": name,
        "manifest": entry,
        "settings": cell_file(name),
        "config_name": entry["config"],
        "config": config(entry["config"]),
        "traffic_name": entry["traffic"],
        "traffic": traffic(entry["traffic"]),
        "chips": int(entry["chips"]),
        "end_to_end": mine(m["end_to_end"]),
        "per_layer": mine(m["per_layer"]),
    }
