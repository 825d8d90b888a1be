"""Faults planted under the timed path, each in the program's module or
class where the timed path calls it, to show that the comparison catches
them (``tests/test_portbench_harness.py`` on the CPU, ``control.py
--fault`` on the card).  ``plant(name, setattr)`` puts fault ``name`` in
place; a test passes ``monkeypatch.setattr`` so that it is undone.

* ``altered_projection``: kernel (d)'s candidates off by 1 % where they
  are produced;
* ``half_left_out``: a chunk's second half given the first half's answers;
* ``unchanged_state``: the CEM update returns its state (moments and
  parameters) unchanged at every outer iteration;
* ``truncated_loop``: the outer loop stops after its first iteration: the
  later iterations write no cost and leave the state as it was;
* ``altered_obstacles``: the local problem's obstacle trajectories off by
  1e-4 where they are produced;
* ``minority_projection``: kernel (d)'s candidates off by 1 % in the last
  three of every eight scenarios of a chunk (a fault on a minority of the
  answers, which a median over them does not see);
* ``minority_answers``: a solve's answer off by 1 % where it is produced,
  in three of every eight calls (by ``idx_mpc``).
"""

from __future__ import annotations

import inspect


def altered_projection(original):
    def outer_project(*a, **k):
        pj = original(*a, **k)
        return pj._replace(**{f: getattr(pj, f) * 1.01 for f in (
            "c_x", "c_y", "x", "y", "xdot", "ydot", "xddot", "yddot", "steering", "acc",
            "steer")})
    return outer_project


def minority_projection(original):
    import torch

    def outer_project(*a, **k):
        pj = original(*a, **k)
        x_obs = a[8] if len(a) > 8 else k.get("x_obs")
        n = 1 if x_obs is None or x_obs.dim() == 2 else x_obs.shape[0]
        rows = pj.c_x.shape[0]
        hit = ((torch.arange(rows, device=pj.c_x.device) // (rows // n)) % 8 >= 5)
        scale = 1 + 0.01 * hit.to(pj.c_x.dtype)
        return pj._replace(**{f: getattr(pj, f) * scale.reshape(-1, *(1,) * (
            getattr(pj, f).dim() - 1)) for f in ("c_x", "c_y", "x", "y", "xdot", "ydot",
                                               "xddot", "yddot", "steering", "acc", "steer")})
    return outer_project


def minority_answers(original):
    def solve(self, idx_mpc, *a, **k):
        r = original(self, idx_mpc, *a, **k)
        return type(r)(*(f * 1.01 for f in r)) if idx_mpc % 8 >= 5 else r
    return solve


def half_left_out(original):
    import torch

    def solve_batch(self, seeds, *a, **k):
        r = original(self, seeds, *a, **k)
        n = len(seeds) // 2
        return type(r)(*(torch.cat([f[:n], f[:len(seeds) - n]]) for f in r))
    return solve_batch


def _tail(original, frozen_from: int):
    """``outer_tail`` that, from iteration ``frozen_from`` on, gives back the
    moments and parameters it was given; iterations past the first also
    write no cost (their ``res`` and ``res_2`` columns are written to
    copies) where ``frozen_from`` is 1."""
    sig = inspect.signature(original)

    def outer_tail(*a, **k):
        b = sig.bind(*a, **k)
        it = b.arguments["it"]
        if it < frozen_from:
            return original(*a, **k)
        if frozen_from:
            b.arguments["res"] = b.arguments["res"].clone()
            b.arguments["res_2"] = b.arguments["res_2"].clone()
        t = original(*b.args, **b.kwargs)
        return t._replace(mean=b.arguments["mean"], cov=b.arguments["cov"],
                          params=b.arguments["params"])
    return outer_tail


def unchanged_state(original):
    return _tail(original, 0)


def truncated_loop(original):
    return _tail(original, 1)


def altered_obstacles(original):
    def local_problem(*a, **k):
        frame, x_obs, y_obs, init = original(*a, **k)
        return frame, x_obs * (1 + 1e-4), y_obs, init
    return local_problem


FAULTS = {
    "altered_projection": ("mpc_mmd_tpu_torch.solver", "outer_project", altered_projection),
    "half_left_out": ("mpc_mmd_tpu_torch", "Solver.solve_batch", half_left_out),
    "unchanged_state": ("mpc_mmd_tpu_torch.solver", "outer_tail", unchanged_state),
    "truncated_loop": ("mpc_mmd_tpu_torch.solver", "outer_tail", truncated_loop),
    "altered_obstacles": ("mpc_mmd_tpu_torch.closedloop", "local_problem",
                          altered_obstacles),
    "minority_projection": ("mpc_mmd_tpu_torch.solver", "outer_project",
                            minority_projection),
    "minority_answers": ("mpc_mmd_tpu_torch", "Solver.solve", minority_answers),
}


def plant(name: str, set_attr=setattr) -> None:
    import importlib
    module, attr, fault = FAULTS[name]
    owner = importlib.import_module(module)
    *path, attr = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    set_attr(owner, attr, fault(getattr(owner, attr)))
