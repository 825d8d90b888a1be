"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` sessions
over a bounded number of periods, with the guard that a session recorded
every launch of the port's kernels.

The profiler now and then records no device event in a session, or drops
one launch's record.  So a session is opened by a short spin kernel (left
out), and its device events of each counted kernel are held to the launches
that the port's own counters (``mpc_mmd_tpu_torch.ops.launch_counts``, which
a graph replay advances by its capture's launches) say the session made.
Up to five sessions are tried; a session that dropped a launch is never
read.  Device busy time is the union of the card's kernel, copy and set
intervals."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

SPAN = "portbench."         # the harness's record_function spans start so


@dataclass
class Session:
    periods: int
    wall_s: float                                # the traced stretch, profiled
    device: List[Tuple[str, float, float]]       # (name, start us, end us)
    spans: List[Tuple[str, float, float]]        # the harness's host spans
    launches: Dict[str, int]                     # wrapper -> launches in the session
    recorded: Dict[str, int] = field(default_factory=dict)   # symbol -> device events

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, lo, hi in sorted(self.device, key=lambda e: e[1]):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e6

    def kernel_s(self, symbol: str) -> float:
        """Device seconds of the events whose name holds ``symbol``."""
        return sum(hi - lo for name, lo, hi in self.device if symbol in name) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        per: Dict[str, float] = {}
        for name, lo, hi in self.device:
            per[name] = per.get(name, 0.0) + (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps between device activity, each named by the
        innermost harness span open on the host where the gap begins."""
        busy = self.busy_intervals()
        gaps = [(hi0, lo1) for (_, hi0), (lo1, _) in zip(busy, busy[1:]) if lo1 > hi0]
        out = []
        for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            open_ = [s for s in self.spans if s[1] <= lo < s[2]]
            name = (min(open_, key=lambda s: s[2] - s[1])[0][len(SPAN):] if open_
                    else "outside the harness's spans")
            out.append([name, (hi - lo) / 1e6])
        return out


def traced(torch, run: Callable[[int], None], periods: int, symbols: Dict[str, Tuple[str, ...]],
           launch_counts: Callable[[], Dict[str, int]], sessions: int = 5
           ) -> Tuple[Optional[Session], List[dict]]:
    """Profile ``run(periods)`` until a session records, for every kernel
    ``symbol`` in ``symbols`` (symbol -> the wrappers that launch it), as
    many device events as its wrappers' counters advanced.  Returns the
    first such session (None if none of ``sessions`` did) and what each
    attempt recorded."""
    from torch.profiler import ProfilerActivity, profile
    attempts = []
    for _ in range(sessions):
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100)
            t0 = time.perf_counter()
            run(periods)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = launch_counts()
        launches = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
        device, spans = [], []
        for e in prof.events():
            lo, hi = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the device side of a harness span is an annotation, no work
                if "spin_kernel" not in e.name and not e.name.startswith(SPAN):
                    device.append((e.name, lo, hi))
            elif e.name.startswith(SPAN):
                spans.append((e.name, lo, hi))
        s = Session(periods, wall, device, spans, launches)
        expected = {sym: sum(launches.get(w, 0) for w in ws) for sym, ws in symbols.items()}
        s.recorded = {sym: sum(1 for name, _, _ in device if sym in name) for sym in symbols}
        attempts.append({"expected": expected, "recorded": s.recorded, "events": len(device)})
        if device and all(s.recorded[k] == expected[k] for k in symbols):
            return s, attempts
    return None, attempts
