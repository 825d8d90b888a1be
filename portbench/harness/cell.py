"""One run of a cell: set-up, the window, the traced stretch, the
comparison with the reference, and the result's line."""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .spec import Spec


@dataclass
class Context:
    """What a traffic driver is given: the card (or the CPU in a test), the
    seed's generators, the cell's parameters and its configuration, as the
    port's ``ProblemConfig`` (``cfg``) and the reference's (``ref_cfg``)."""
    torch: Any
    device: Any
    seed: int
    params: Dict[str, Any]
    config: Dict[str, Any]
    cfg: Any
    ref_cfg: Any
    trace: bool = False
    lower: bool = False     # the control: the reference with TF32 on in the program's place
    record: bool = False    # keep what the comparison read, both sides, under readings["raw"]

    def rng(self, stream: int) -> np.random.Generator:
        """A generator of stream ``stream`` of the seed (any whole number)."""
        return np.random.default_rng(np.random.SeedSequence([self.seed % 2 ** 63, stream]))

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


@dataclass
class Observation:
    """What the metric readers read (``metrics/<name>.py``, ``read(obs)``)."""
    cfg: Any                        # the reference's ProblemConfig of the cell
    window_s: float
    setup_s: float
    periods: List[float]            # seconds of each period of the window
    work: List[int]                 # solves of each period
    host: Dict[str, List[float]]    # the driver's own host timings, by name
    nodes: Optional[int] = None     # graph nodes replayed a period
    session: Any = None             # trace.Session of the traced stretch
    counts: Dict[str, Any] = field(default_factory=dict)   # roofline modules
    chunk: int = 1                  # scenarios a period solves at once
    frenet: bool = False

    def per_period(self, seconds: float) -> float:
        return seconds / self.session.periods

    @property
    def mean_period_s(self) -> float:
        return sum(self.periods) / len(self.periods)

    @property
    def units(self) -> float:
        """Solves a period."""
        return sum(self.work) / len(self.work)

    def kernel_bounds(self):
        """(bound s, ops, device s) summed over the traced stretch per kernel
        symbol that a count file names and the stretch launched."""
        out = {}
        s = self.session
        for mod in self.counts.values():
            n = s.launches.get(mod.WRAPPER, 0)
            if not n:
                continue
            from .peaks import bound_s
            nbytes, ops, int_ops = mod.count(self.cfg, self.chunk, self.frenet)
            b, o, _ = out.get(mod.SYMBOL, (0.0, 0.0, 0.0))
            out[mod.SYMBOL] = (b + n * bound_s(nbytes, ops, int_ops), o + n * ops,
                               s.kernel_s(mod.SYMBOL))
        return out


def metric_values(spec: Spec, metrics, obs: Observation) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = spec.reader(m["name"]).read(obs)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec: Spec, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, driver=None, lower: bool = False,
             readings: Optional[dict] = None) -> Dict[str, Any]:
    """One run of ``cell``; ``driver`` (a test's) in place of the cell's
    ``traffic/<driver>.py``; ``lower``: the control in the program's place
    in the comparison; ``readings``, a dict, gets every reading of the
    comparison, by name."""
    import torch
    from mpc_mmd_tpu_torch import config as port_config
    from ..reference.config import from_dict
    from .trace import traced

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    conf = cell["config_file"]
    ctx = Context(torch, device, seed, cell["params"], conf,
                  port_problem(port_config, conf["problem"]), from_dict(conf["problem"]), trace, lower,
                  readings is not None)
    driver = driver or spec.module("traffic", cell["driver"])

    t_build = time.perf_counter()
    state = driver.build(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start

    periods, work = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        p0 = time.perf_counter()
        n = driver.period(state)
        periods.append(time.perf_counter() - p0)
        work.append(n)
        driver.between(state)
    window_s = time.perf_counter() - t0

    obs = Observation(ctx.ref_cfg, window_s, setup_s, periods, work,
                      getattr(state, "host", {}), chunk=getattr(state, "chunk", 1),
                      frenet=getattr(state, "frenet", False))
    attempts = None
    if trace:
        from mpc_mmd_tpu_torch import ops
        obs.counts = spec.counts()
        symbols: Dict[str, tuple] = {}
        for mod in obs.counts.values():
            symbols.setdefault(mod.SYMBOL, ())
            symbols[mod.SYMBOL] += (mod.WRAPPER,)

        def stretch(k):
            for _ in range(k):
                driver.period(state, traced=True)
                driver.between(state)
        obs.session, attempts = traced(torch, stretch, int(cell["params"]["traced_periods"]),
                                       symbols, ops.launch_counts)
        obs.nodes = driver.graph_nodes(state)

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = driver.failed(state)
    driver.free_program(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_compare = time.perf_counter()
    compared = driver.compare(state, ctx)
    if readings is not None:
        readings.update(getattr(state, "readings", {}))
    ctx.sync()
    compare_s = time.perf_counter() - t_compare

    metrics = spec.metrics(cell["name"], trace)
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in compared.values())
    result: Dict[str, Any] = {
        "correct": bool(correct and failed == 0),
        "attempted": int(sum(work)),
        "failed": int(failed),
        "metrics": metric_values(spec, metrics, obs) if (obs.session or not trace) else {},
        "device": device_record(torch, device, peak, obs.session),
    }
    if obs.session is not None:
        result["breakdown"] = {"device_ops": obs.session.top_ops(),
                               "idle_gaps": obs.session.idle_gaps()}
    elif trace:
        result["trace_attempts"] = attempts
    result["seconds"] = {"imports": t_build - t_start, "build": setup_s - (t_build - t_start),
                         "window": window_s, "periods": len(periods), "compare": compare_s}
    result["compared"] = compared
    return result


def port_problem(port_config, problem: dict):
    """The port's ``ProblemConfig`` from the configuration file's nested
    dict, group by group."""
    import dataclasses
    groups = {f.name: f for f in dataclasses.fields(port_config.ProblemConfig)}
    kw = {}
    for name, value in problem.items():
        if isinstance(value, dict):
            cls = getattr(port_config, groups[name].type) if isinstance(
                groups[name].type, str) else groups[name].type
            kw[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in value.items()})
        else:
            kw[name] = value
    return port_config.ProblemConfig(**kw)


def device_record(torch, device, peak: int, session) -> Dict[str, Any]:
    if device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if session is not None:
        rec["busy_s"] = session.busy_s()
        rec["window_s"] = session.wall_s
    return rec
