"""The solve as one program on the card: CUDA graphs of the outer CEM loop.

Counterpart of ``jax.jit`` over the JAX package's solve.  There a solve is
one jitted program whose outer loop is a ``lax.scan``, and the only
host-device boundary is the jitted call itself (``mpc_mmd_tpu/solver.py``
module docstring, the scan at ``:321``, ``jax.jit`` at ``:359``, and a
chunk of scenarios a jitted ``lax.map`` at ``:372``).

Here a solver splits a solve in two: a host prologue, which turns the
call's arguments into named input tensors (the key table of the draws,
the initial state, the CEM moments, the obstacles, ``v_des`` and, on the
road, the Frenet frame), and a device body, which reads only those inputs
and the solver's fixed tensors (the workspace and the solver-fixed draws)
and returns named output tensors.  On the CPU the body runs eagerly on the
inputs.  On the card a :class:`GraphCache` runs it as a captured
``torch.cuda.CUDAGraph``:

* the first solve of a key (the inputs' shapes and dtypes, and what else
  the body fixes when it is traced, such as the inner CEM's selection)
  copies its inputs into static buffers, runs the body once eagerly on
  them as the warm-up (its result is the solve's, and the kernels' one-time
  CUDA calls happen in it), then captures the body on a side stream; all
  of a solver's graphs share one memory pool;
* every later solve of that key copies its inputs into the static buffers,
  replays the graph and clones the outputs, so that a result the caller
  keeps is not overwritten by the next solve.  That is all the host does
  for a solve.

Inputs that come from the host go through pinned staging buffers owned by
the graph and reach the card without a host synchronisation.  Before a
solve refills them it waits for the card to have copied the previous
solve's out of them (``torch.cuda.Event.synchronize``), which it has done
unless the host runs more than a solve ahead.  A capture that fails
raises; nothing falls back to the eager path.

The kernel wrappers count launches in Python, and a replay calls none of
them: a graph keeps the counts its capture added (and takes them back,
since a capture runs nothing) and adds them at every replay, so that a
graphed solve counts the launches of the eager one.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional

import torch

from .ops import add_launches, launch_counts, set_launch_counts

Tensors = Dict[str, torch.Tensor]


def graph_nodes(graph) -> int:
    """Node count of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``,
    from the CUDA driver (``cuGraphGetNodes``)."""
    driver = ctypes.CDLL("libcuda.so.1")
    fn = driver.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = fn(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    return count.value


@dataclass
class Captured:
    """One captured body: its static inputs and outputs, the graph (any
    object with ``replay()``), the wrappers' launches of one replay, the
    graph's nodes, and the seconds its capture and instantiation took."""

    graph: Any
    inputs: Tensors
    outputs: Tensors = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    nodes: int = 0
    capture_s: float = 0.0
    instantiate_s: float = 0.0
    replays: int = 0
    _staging: Tensors = field(default_factory=dict)
    _copied: Optional[Any] = None      # a torch.cuda.Event after the staged copies

    def load(self, values: Tensors) -> None:
        """Copies ``values`` (by input name, on any device) into the static
        inputs, a host tensor through its pinned staging buffer."""
        staged = False
        for name, value in values.items():
            dst = self.inputs[name]
            if dst.device.type == "cuda" and value.device.type == "cpu":
                if not staged and self._copied is not None:
                    self._copied.synchronize()
                staged = True
                buf = self._staging.get(name)
                if buf is None:
                    buf = self._staging[name] = torch.empty(
                        dst.shape, dtype=dst.dtype, pin_memory=True)
                buf.copy_(value)
                dst.copy_(buf, non_blocking=True)
            else:
                dst.copy_(value)
        if staged:
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record()

    def replay(self, values: Tensors) -> Tensors:
        """One solve: the inputs in, a replay, the wrappers' counts, and
        clones of the outputs."""
        self.load(values)
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
        return {name: t.clone() for name, t in self.outputs.items()}

    def stats(self) -> Dict[str, Any]:
        return {"nodes": self.nodes, "capture_s": self.capture_s,
                "instantiate_s": self.instantiate_s, "replays": self.replays,
                "launches": dict(self.launches)}


class GraphCache:
    """A solver's captured bodies by key, in one memory pool (see the
    module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: Dict[Hashable, Captured] = {}
        self._stream = None
        self._pool = None

    def run(self, key: Hashable, inputs: Tensors, body: Callable[..., Tensors]
            ) -> Tensors:
        """``body(**inputs)`` on the card: a replay of the key's graph, or
        at its first solve the eager warm-up and the capture."""
        captured = self.graphs.get(key)
        if captured is not None:
            return captured.replay(inputs)
        out, self.graphs[key] = self._capture(inputs, body)
        return out

    def _capture(self, inputs: Tensors, body: Callable[..., Tensors]):
        static = {name: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for name, t in inputs.items()}
        captured = Captured(torch.cuda.CUDAGraph(keep_graph=True), static)
        captured.load(inputs)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side, current = self._stream, torch.cuda.current_stream(self.device)
        # the warm-up on the capture's stream, so that the libraries'
        # handles and workspaces for it exist before the capture
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = body(**static)
        current.wait_stream(side)
        for t in out.values():
            t.record_stream(current)
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(captured.graph, pool=self._pool, stream=side):
                captured.outputs = body(**static)
        finally:
            after = launch_counts()
            set_launch_counts(before)          # the capture launched nothing
        captured.capture_s = time.perf_counter() - t0
        captured.launches = {k: n - before[k] for k, n in after.items()
                             if n != before[k]}
        t0 = time.perf_counter()
        captured.graph.instantiate()
        captured.instantiate_s = time.perf_counter() - t0
        captured.nodes = graph_nodes(captured.graph)
        return out, captured

    def stats(self) -> List[Dict[str, Any]]:
        """Per graph: its key and :meth:`Captured.stats`."""
        return [dict(key=key, **g.stats()) for key, g in self.graphs.items()]
