"""Closed-loop MPC episodes against the synthetic plant.

Runs receding-horizon episodes of the on-road workload in the chosen risk
mode, prints one JSON line per episode (collision, steps, least margin,
mean and p99 solve ms; the first solve, which builds the kernels on the
card, is left out of the times when there are others) and a summary line,
and optionally renders the driven trajectory.  The flags are the JAX
package's ``mpc_mmd_tpu.cli.closedloop`` flags, plus ``--device`` (default
cuda; without a card it fails, it never runs on the CPU instead).

Usage:
    python -m mpc_mmd_tpu_torch.cli.closedloop --mode mmd_opt --episodes 3 \
        --route curved --noise gaussian --noise_level 0.1
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from . import resolve_device
from ..closedloop import make_route, run_episode
from ..config import onroad_workload
from ..solver_frenet import FrenetSolver


def animate_episode(result, cfg, route_kind: str, out_path: str,
                    fps: int = 10, stride: int = 2,
                    window: float = 60.0) -> str:
    """Birdview animation (GIF) of an episode: an ego-centred window with
    the route, the obstacles' safety ellipses, the ego's trail and its
    heading.  Imports matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation
    from matplotlib.patches import Ellipse

    from .report import _animation_writer

    rx, ry = make_route(route_kind)
    ego = result.ego_trace
    obs = result.obs_trace
    fig, ax = plt.subplots(figsize=(7, 5))

    def draw(k):
        ax.clear()
        x_e, y_e = ego[k, 0], ego[k, 1]
        ax.plot(rx, ry, "k--", lw=0.7, alpha=0.6)
        ax.plot(ego[:k + 1, 0], ego[:k + 1, 1], "b-", lw=1.4)
        ax.plot(x_e, y_e, "b^", ms=9)
        if obs.shape[1]:
            for ox, oy in obs[k]:
                ax.add_patch(Ellipse((ox, oy), 2 * cfg.obstacles.a_obs,
                                     2 * cfg.obstacles.b_obs,
                                     facecolor="tab:red", alpha=0.25,
                                     edgecolor="tab:red"))
                ax.plot(ox, oy, "rs", ms=5)
        status = "COLLIDED" if (result.collided and k >= len(ego) - stride) \
            else f"v={ego[k, 2]:.1f} m/s"
        ax.set_title(f"step {k}/{len(ego)}  {status}")
        ax.set_xlim(x_e - window * 0.3, x_e + window)
        ax.set_ylim(y_e - window * 0.4, y_e + window * 0.4)
        ax.set_aspect("equal")

    anim = FuncAnimation(fig, draw, frames=range(0, len(ego), stride))
    out_path, writer = _animation_writer(out_path, fps)
    anim.save(out_path, writer=writer)
    plt.close(fig)
    return out_path


def plot_episodes(results, route_kind: str, out_path: str) -> str:
    """The driven trajectories over the route (PNG).  Imports matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(12, 5))
    rx, ry = make_route(route_kind)
    ax.plot(rx[:3000], ry[:3000], "k--", lw=0.8, label="route")
    for r in results:
        if len(r.ego_trace):
            ax.plot(r.ego_trace[:, 0], r.ego_trace[:, 1], lw=1.2)
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def _budget(text: str):
    return tuple(int(v) for v in text.split("x"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="mmd_opt",
                   choices=["mmd_opt", "mmd_random", "cvar", "saa", "det"])
    p.add_argument("--episodes", type=int, default=1)
    p.add_argument("--route", default="curved",
                   choices=["straight", "curved", "circuit"])
    p.add_argument("--noise", default="gaussian", choices=["gaussian", "beta"])
    p.add_argument("--noise_level", type=float, default=0.1)
    p.add_argument("--num_reduced", type=int, default=4)
    p.add_argument("--num_obs", type=int, default=4)
    p.add_argument("--num_prime", type=int, default=50)
    p.add_argument("--v_des", type=float, default=15.0)
    p.add_argument("--max_steps", type=int, default=400)
    p.add_argument("--goal_arc", type=float, default=300.0)
    p.add_argument("--plot", type=str, default=None,
                   help="write the driven trajectories to this PNG")
    p.add_argument("--animate", type=str, default=None,
                   help="write a birdview GIF of the last episode")
    p.add_argument("--seed_base", type=int, default=0,
                   help="episode seed offset (episode seed = seed_base + "
                        "episode index)")
    p.add_argument("--actuation", default="direct", choices=["direct", "pid"],
                   help="pid = the throttle/brake PID actuation (PIDActuator)")
    p.add_argument("--inner_budget", type=str, default=None,
                   help="SxIT (e.g. 64x12): inner-CEM samples x iterations")
    p.add_argument("--outer_budget", type=str, default=None,
                   help="BxIT (e.g. 64x12): outer-CEM candidates x iterations")
    p.add_argument("--obstacles", type=str, nargs="*", default=None,
                   help="obstacles as s:l pairs along the route, e.g. "
                        "60:0 140:1.5 (default: the built-in pair)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = onroad_workload(num_reduced=args.num_reduced, num_obs=args.num_obs,
                          noise=args.noise, noise_level=args.noise_level,
                          num_prime=args.num_prime, mode=args.mode)
    if args.inner_budget:
        S_b, it_b = _budget(args.inner_budget)
        cfg = cfg.replace(beta_cem=dataclasses.replace(
            cfg.beta_cem, num_samples_cem=S_b, maxiter=it_b))
    if args.outer_budget:
        B_b, it_b = _budget(args.outer_budget)
        cfg = cfg.replace(cem=dataclasses.replace(
            cfg.cem, num_batch=B_b, maxiter_cem=it_b))
    solver = FrenetSolver(cfg, device=dev)
    kw = {}
    if args.obstacles is not None:
        kw["obstacles_s_l"] = tuple(
            tuple(float(v) for v in o.split(":")) for o in args.obstacles)

    results = []
    for ep in range(args.episodes):
        r = run_episode(cfg, route_kind=args.route, v_des=args.v_des,
                        max_steps=args.max_steps, goal_arc=args.goal_arc,
                        seed=args.seed_base + ep, solver=solver,
                        actuation=args.actuation, **kw)
        results.append(r)
        times = r.solve_times[1:] or r.solve_times
        print(json.dumps({
            "episode": args.seed_base + ep, "collided": r.collided,
            "steps": r.steps,
            "min_margin": round(r.min_obstacle_margin, 3),
            "mean_solve_ms": round(1e3 * float(np.mean(times)), 2),
            "p99_solve_ms": round(1e3 * float(np.percentile(times, 99)), 2),
        }), flush=True)

    n_coll = sum(r.collided for r in results)
    print(json.dumps({"episodes": len(results), "collisions": n_coll,
                      "collision_rate": n_coll / len(results)}))
    if args.animate and results:
        print(animate_episode(results[-1], cfg, args.route, args.animate))
    if args.plot and results:
        print(plot_episodes(results, args.route, args.plot))
    return results


if __name__ == "__main__":
    main()
