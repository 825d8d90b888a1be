"""A cell's files, found by name: the cell's entry in ``BENCHMARK.json``,
its workload file ``workloads/<cell>.json``, its configuration
``configs/<config>.json``, its traffic driver ``traffic/<driver>.py``, the
metric readers ``metrics/<metric>.py`` and the kernel counts
``roofline/<kernel>.py``.  A later cell, configuration, driver, metric or
count is a new file and needs no edit here.

``roots`` lists directories searched before the benchmark's own (a test
hands its own files in this way)."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parents[1]          # portbench/
CHECKOUT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class Spec:
    def __init__(self, roots: Sequence[Path] = (), benchmark: Optional[dict] = None):
        self.roots = [Path(r) for r in roots] + [HERE]
        if benchmark is None:
            benchmark = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
        self.benchmark = benchmark

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        if not NAME.match(name):
            raise ValueError(f"not a name: {name!r}")
        for root in self.roots:
            path = root / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under {self.roots}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self._find(kind, name, ".json").read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        path = self._find(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        """The cell's entry of ``BENCHMARK.json`` with its workload file
        (``driver``, ``params``) and its configuration file under
        ``config_file``."""
        entries = [w for w in self.benchmark["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = dict(entries[0])
        cell.update(self.json("workloads", name))
        cell["config_file"] = self.json("configs", cell["config"])
        return cell

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end ones
        untraced, its per-layer ones traced.  A metric with ``workloads``
        is the listed cells'; one without is every cell's that reports the
        metric it moves (an end-to-end one without is every cell's)."""
        e2e = [m for m in self.benchmark["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.benchmark["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def reader(self, metric: str) -> ModuleType:
        """``metrics/<metric>.py``, else ``metrics/<part before the first
        dot>.py`` (one reader serves ``device_busy_ms.solve`` and
        ``device_busy_ms.step``)."""
        try:
            return self.module("metrics", metric)
        except FileNotFoundError:
            return self.module("metrics", metric.split(".")[0])

    def counts(self) -> Dict[str, ModuleType]:
        """Every kernel count file, by name."""
        seen: Dict[str, ModuleType] = {}
        for root in reversed(self.roots):
            for path in sorted((root / "roofline").glob("*.py")):
                if path.stem != "__init__":
                    seen[path.stem] = self.module("roofline", path.stem)
        return seen
