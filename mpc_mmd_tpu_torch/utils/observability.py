"""Metrics, timing and profiling.

Counterpart of ``mpc_mmd_tpu/utils/observability.py``: a JSONL metric
stream written by process 0 only, wall-clock phase timers, and a
``torch.profiler`` trace in place of ``jax.profiler`` (the sweep CLI's
``--trace``), summarised as device busy time, idle share
and kernel launches.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def process_index() -> int:
    """This process's rank under ``torch.distributed``, else 0."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _plain(v):
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        v = np.asarray(v).tolist()
    return v


@dataclass
class MetricLogger:
    """Append-only JSONL metric stream (process 0 only under distribution)."""

    path: Optional[str] = None
    _records: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, event: str, **fields) -> None:
        rec = {"t": time.time(), "event": event}
        rec.update({k: _plain(v) for k, v in fields.items()})
        self._records.append(rec)
        if self.path and process_index() == 0:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def records(self, event: Optional[str] = None):
        if event is None:
            return list(self._records)
        return [r for r in self._records if r["event"] == event]


@contextlib.contextmanager
def phase_timer(logger: MetricLogger, phase: str, **fields):
    """Wall-clock timer for a named phase; logs {"event": "phase", ...}."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log("phase", phase=phase,
                   seconds=time.perf_counter() - t0, **fields)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the CPU and, where there is one, the CUDA
    card (no-op when ``log_dir`` is None).  Writes the Chrome trace and
    its :func:`trace_summary` under ``log_dir``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        # the window the summary divides by: the profiler's own start-up
        # and event processing stay outside it
        t0 = time.perf_counter()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    name = f"p{process_index()}_{os.getpid()}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{name}.json"))
    with open(os.path.join(log_dir, f"summary_{name}.json"), "w") as f:
        json.dump(trace_summary(prof, wall_s), f, indent=1)


def trace_summary(prof, wall_s: float, top: int = 12) -> Dict[str, Any]:
    """Device busy ms (the union of the card's kernel and copy intervals),
    idle share of ``wall_s``, the number of device events, and the ``top``
    kernels by device time as [name, ms, calls]."""
    spans, per_kernel = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_us, end = 0.0, -float("inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy_ms = busy_us / 1e3
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": 1e3 * wall_s, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (1e3 * wall_s),
            "device_events": len(spans),
            "top": [[name, round(ms, 3), n] for name, (ms, n) in ranked]}
