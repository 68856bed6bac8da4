"""Finding a cell's files by name.

A cell is ``workloads/<cell>.json`` (its configuration's name, its traffic,
the chips it needs, why it exists, and the limits of its correctness
check); its configuration is ``configs/<config>.json``; its traffic's job
kind is the module ``traffic/<kind>.py``; a metric is read by
``metrics/<metric>.py``.  Each is looked up under the roots in order
(``portbench/`` alone by default), so a cell, a configuration, a job kind or
a metric is added by adding a file.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOTS = (HERE,)


def find(rel: str, roots=ROOTS) -> pathlib.Path:
    for root in roots:
        path = pathlib.Path(root) / rel
        if path.exists():
            return path
    raise FileNotFoundError(f"{rel} is under none of {[str(r) for r in roots]}")


def load_json(rel: str, roots=ROOTS) -> dict:
    with open(find(rel, roots)) as fp:
        return json.load(fp)


def load_module(rel: str, roots=ROOTS):
    path = find(rel, roots)
    name = "portbench._found." + rel.replace("/", ".").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, roots=ROOTS) -> tuple[dict, dict]:
    """(workload, configuration) of the cell ``name``."""
    cell = load_json(f"workloads/{name}.json", roots)
    if cell.get("name") != name:
        raise ValueError(f"workloads/{name}.json names the cell {cell.get('name')!r}")
    return cell, load_json(f"configs/{cell['config']}.json", roots)


def kind(cell: dict, roots=ROOTS):
    return load_module(f"traffic/{cell['traffic']['kind']}.py", roots)


def metric(name: str, roots=ROOTS):
    return load_module(f"metrics/{name}.py", roots)
