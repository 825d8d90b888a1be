"""Reporting: collision-percentage box plots and rollout-cloud figures.

Counterpart of ``mpc_mmd_tpu/cli/report.py``.  The box plots read the
stats files of cli/validate.py (either package's); ``trajectories`` and
``animate`` re-roll a store's solves through the validator's noise and K4
on ``--device``.  matplotlib is imported only by the function that draws.

Usage:
    python -m mpc_mmd_tpu_torch.cli.report boxplot --stats ./stats/... --labels cvar --out box.png
    python -m mpc_mmd_tpu_torch.cli.report grid --stats_root ./stats --noise_levels 0.1 \\
        --num_reduced_sets 10 --num_obs 6 --num_prime 50 --out grid.png
    python -m mpc_mmd_tpu_torch.cli.report trajectories --data ./data/... --out traj.png
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def labelled_boxplot(ax, data, labels, **kw):
    """``ax.boxplot`` with tick labels: ``tick_labels`` from matplotlib 3.9,
    ``labels`` before it."""
    try:
        return ax.boxplot(data, tick_labels=labels, **kw)
    except TypeError:
        return ax.boxplot(data, labels=labels, **kw)


def boxplot(stats_paths, labels, n_mc: int, out_path: str):
    plt = _pyplot()
    data = []
    for path in stats_paths:
        with np.load(os.path.join(path, "validation.npz")) as z:
            denom = int(z["n_mc"]) if "n_mc" in z else n_mc
            data.append(z["coll_count"] / denom * 100.0)

    fig, ax = plt.subplots(figsize=(1.8 * len(data) + 2, 4))
    labelled_boxplot(ax, data, labels, showmeans=True)
    ax.set_ylabel("collision %")
    ax.set_title("Monte-Carlo collision percentage per accepted solve")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def grid_boxplot(stats_root: str, noise: str, noise_levels, num_reduced_sets,
                 num_obs: int, num_prime: int, n_mc: int, out_path: str,
                 modes=("mmd_opt", "cvar")):
    """(num_reduced x noise_level) grid of paired box plots (the reference's
    plot_box_plots.py:102-143) over the stats npz of validate --compare;
    values are collision % of the n_mc recorded in each npz."""
    plt = _pyplot()
    mode_labels = {"mmd_opt": r"$r_{MMD}^{emp}$", "cvar": r"$r_{CVaR}^{emp}$",
                   "mmd_random": r"$r_{MMD}^{rand}$", "saa": r"$r_{SAA}$"}
    colors = {"mmd_opt": "tab:red", "cvar": "tab:cyan",
              "mmd_random": "tab:blue", "saa": "tab:green"}

    nrows, ncols = len(num_reduced_sets), len(noise_levels)
    fig, axs = plt.subplots(nrows, ncols, squeeze=False,
                            figsize=(4.0 * ncols, 3.0 * nrows),
                            layout="constrained")
    for i, num_reduced in enumerate(num_reduced_sets):
        for j, lvl in enumerate(noise_levels):
            ax = axs[i][j]
            path = os.path.join(
                stats_root, f"{noise}_noise", f"noise_{round(lvl * 100)}",
                f"ts_{num_prime}", f"{num_reduced}_samples_{num_obs}_obs.npz")
            if not os.path.exists(path):
                ax.set_axis_off()
                continue
            with np.load(path) as z:
                present = [m for m in modes if f"coll_{m}" in z]
                denom = int(z["n_mc"]) if "n_mc" in z else n_mc
                data = [z[f"coll_{m}"] / denom * 100.0 for m in present]
            bp = ax.boxplot(data, showfliers=False, widths=0.8,
                            patch_artist=False)
            for box, m in zip(bp["boxes"], present):
                box.set(color=colors.get(m, "black"), linewidth=2.5)
            for med in bp["medians"]:
                med.set(color="orange", linewidth=2.5)
            ax.text(0.05, 0.95, f"$N={num_reduced}$",
                    transform=ax.transAxes, va="top",
                    bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5))
            # Wilcoxon p of the first present pair, from the JSON sidecar
            sidecar = path.replace(".npz", ".json")
            if len(present) >= 2 and os.path.exists(sidecar):
                with open(sidecar) as f:
                    pairs = json.load(f).get("pairs", {})
                ps = (pairs.get(f"{present[0]}_vs_{present[1]}")
                      or pairs.get(f"{present[1]}_vs_{present[0]}"))
                if ps and ps.get("p_wilcoxon") is not None:
                    ax.text(0.95, 0.95, f"p={ps['p_wilcoxon']:.3f}",
                            transform=ax.transAxes, va="top", ha="right",
                            fontsize=9,
                            bbox=dict(boxstyle="round", facecolor="white",
                                      alpha=0.6))
            ax.set_xticks(range(1, len(present) + 1),
                          [mode_labels.get(m, m) for m in present])
            if j == 0:
                ax.set_ylabel("%Collisions", fontweight="bold")
            if i == nrows - 1:
                ax.set_xlabel(f"{noise} noise {lvl}", fontweight="bold")
    fig.suptitle(f"MC collision %, {noise} noise, horizon {num_prime}",
                 fontweight="bold")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def pick_showcase_solves(stats_npz: str, mode: str, other: str,
                         other_min: int = 80, self_max: int = 0):
    """The reference's cherry-pick rule (plot_traj_video.py:285): scenarios
    where ``mode`` has at most ``self_max`` colliding MC rollouts while
    ``other`` has at least ``other_min``.  Returns ``mode``'s ResultStore
    rows (the idx_{mode} join map of validate_compare)."""
    with np.load(stats_npz) as z:
        sel = (z[f"coll_{mode}"] <= self_max) & (z[f"coll_{other}"] >= other_min)
        return np.asarray(z[f"idx_{mode}"])[sel]


def _rerolled(data_root: str, solve_indices, n_mc: int, seed: int, device):
    """(cfg, meta, arrays, [(i, path x, path y, rollouts x, rollouts y)])
    for the store rows ``solve_indices``: the validator's rollouts of each,
    drawn as row i."""
    import torch

    from . import resolve_device
    from .validate import config_of
    from ..qp import build_workspace
    from ..utils.io_store import ResultStore
    from ..validate import mc_rollouts
    from ..noise import JaxNoise

    dev = resolve_device(device)
    store = ResultStore(data_root)
    meta = store.meta
    cfg = config_of(meta)
    ws = build_workspace(cfg, dev)
    noise = JaxNoise(dev)
    arrays = store.concatenated()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    out = []
    with torch.no_grad():
        for i in solve_indices:
            cx, cy = f32(arrays["cx"][i:i + 1]), f32(arrays["cy"][i:i + 1])
            xr, yr = mc_rollouts(cfg, ws, cx, cy, f32(arrays["init_state"][i]),
                                 noise, seed, [i], n_mc)
            out.append((i, (cx @ ws.P.T)[0].cpu().numpy(),
                        (cy @ ws.P.T)[0].cpu().numpy(),
                        xr[0].cpu().numpy(), yr[0].cpu().numpy()))
    return cfg, meta, arrays, out


def trajectories(data_root: str, out_path: str, n_mc: int = 200,
                 n_solves: int = 4, seed: int = 0, solve_indices=None,
                 device="cuda"):
    """Rollout clouds of up to ``n_solves`` stored solves, one panel each."""
    if solve_indices is None:
        from ..utils.io_store import ResultStore
        solve_indices = range(len(ResultStore(data_root).concatenated()["cx"]))
    solve_indices = list(solve_indices)[:n_solves]
    n = len(solve_indices)
    if n == 0:
        raise ValueError("no solves selected (cherry-pick matched nothing?)")
    cfg, meta, arrays, rolled = _rerolled(data_root, solve_indices, n_mc, seed,
                                          device)
    T = cfg.horizon.num_prime
    plt = _pyplot()
    fig, axes = plt.subplots(n, 1, figsize=(12, 2.6 * n), squeeze=False)
    for row, (i, px, py, xr, yr) in enumerate(rolled):
        ax = axes[row][0]
        ax.plot(xr.T, yr.T, color="tab:blue", alpha=0.05, lw=0.5)
        ax.plot(px, py, "k-", lw=1.5)
        for o in range(meta["num_obs"]):
            ax.plot(arrays["x_obs_traj"][i][o][:T],
                    arrays["y_obs_traj"][i][o][:T], "r.", ms=2)
        for yline in (cfg.lane.y_lb, cfg.lane.y_ub):
            ax.axhline(yline, color="gray", ls="--", lw=0.8)
        ax.set_ylim(cfg.lane.y_lb - 2, cfg.lane.y_ub + 2)
        ax.set_ylabel(f"solve {i}")
    axes[-1][0].set_xlabel("x [m]")
    fig.suptitle(f"{meta['mode']} noisy rollout clouds "
                 f"({meta['noise']}@{meta['noise_level']})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def _animation_writer(out_path: str, fps: int):
    """The animation writer for the output extension: FFMpegWriter for
    ``.mp4`` when ffmpeg exists, else a GIF next to the requested path
    (PillowWriter ships with matplotlib).  Returns (actual_out_path, writer).
    """
    import sys

    from matplotlib import animation

    if out_path.lower().endswith(".mp4"):
        if animation.FFMpegWriter.isAvailable():
            return out_path, animation.FFMpegWriter(fps=fps)
        out_gif = os.path.splitext(out_path)[0] + ".gif"
        print(f"report: ffmpeg not available, writing {out_gif} instead of "
              f"{out_path}", file=sys.stderr)
        out_path = out_gif
    return out_path, animation.PillowWriter(fps=fps)


def animate(data_root: str, out_path: str, n_mc: int = 100,
            solve_idx: int = 0, seed: int = 0, fps: int = 10, device="cuda"):
    """Animated rollout cloud of one stored solve (plot_traj_video.py)."""
    from ..utils.io_store import ResultStore
    i = min(solve_idx, len(ResultStore(data_root).concatenated()["cx"]) - 1)
    cfg, meta, arrays, rolled = _rerolled(data_root, [i], n_mc, seed, device)
    _, px, py, xr, yr = rolled[0]
    T = cfg.horizon.num_prime
    xo = arrays["x_obs_traj"][i][:, :T]
    yo = arrays["y_obs_traj"][i][:, :T]

    plt = _pyplot()
    from matplotlib.animation import FuncAnimation
    fig, ax = plt.subplots(figsize=(12, 3.5))
    ax.set_xlim(xr.min() - 5, xr.max() + 10)
    ax.set_ylim(cfg.lane.y_lb - 3, cfg.lane.y_ub + 3)
    for yline in (cfg.lane.y_lb, cfg.lane.y_ub):
        ax.axhline(yline, color="gray", ls="--", lw=0.8)
    cloud = ax.scatter([], [], s=2, alpha=0.25, color="tab:blue")
    obs_sc = ax.scatter([], [], s=60, color="tab:red", marker="s")
    best, = ax.plot([], [], "k-", lw=1.5)

    def frame(t):
        cloud.set_offsets(np.c_[xr[:, t], yr[:, t]])
        obs_sc.set_offsets(np.c_[xo[:, t], yo[:, t]])
        best.set_data(px[:t * (100 // T) + 1], py[:t * (100 // T) + 1])
        return cloud, obs_sc, best

    anim = FuncAnimation(fig, frame, frames=T, blit=True)
    out_path, writer = _animation_writer(out_path, fps)
    anim.save(out_path, writer=writer)
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("boxplot")
    b.add_argument("--stats", type=str, nargs="+", required=True)
    b.add_argument("--labels", type=str, nargs="+", required=True)
    b.add_argument("--n_mc", type=int, default=1000)
    b.add_argument("--out", type=str, required=True)
    g = sub.add_parser("grid")
    g.add_argument("--stats_root", type=str, required=True)
    g.add_argument("--noise", type=str, default="gaussian")
    g.add_argument("--noise_levels", type=float, nargs="+", required=True)
    g.add_argument("--num_reduced_sets", type=int, nargs="+", required=True)
    g.add_argument("--num_obs", type=int, required=True)
    g.add_argument("--num_prime", type=int, required=True)
    g.add_argument("--n_mc", type=int, default=1000)
    g.add_argument("--modes", type=str, nargs="+",
                   default=["mmd_opt", "cvar"])
    g.add_argument("--out", type=str, required=True)
    t = sub.add_parser("trajectories")
    t.add_argument("--data", type=str, required=True)
    t.add_argument("--out", type=str, required=True)
    t.add_argument("--n_mc", type=int, default=200)
    t.add_argument("--n_solves", type=int, default=4)
    t.add_argument("--pick_stats", type=str, default=None,
                   help="paired stats npz from validate --compare: render "
                        "only scenarios where this mode is clean and the "
                        "other collides (plot_traj_video.py:285)")
    t.add_argument("--pick_self", type=str, default="mmd_opt")
    t.add_argument("--pick_other", type=str, default="cvar")
    t.add_argument("--pick_other_min", type=int, default=80)
    a = sub.add_parser("animate")
    a.add_argument("--data", type=str, required=True)
    a.add_argument("--out", type=str, required=True)
    a.add_argument("--n_mc", type=int, default=100)
    a.add_argument("--solve_idx", type=int, default=0)
    for s in (t, a):
        s.add_argument("--device", default="cuda",
                       help="torch device of the re-rolled rollouts (default "
                            "cuda; fails without a card)")
    args = p.parse_args(argv)
    if args.cmd == "boxplot":
        print(boxplot(args.stats, args.labels, args.n_mc, args.out))
    elif args.cmd == "grid":
        print(grid_boxplot(args.stats_root, args.noise, args.noise_levels,
                           args.num_reduced_sets, args.num_obs,
                           args.num_prime, args.n_mc, args.out,
                           modes=tuple(args.modes)))
    elif args.cmd == "trajectories":
        picks = None
        if args.pick_stats:
            from ..utils.io_store import ResultStore
            store_mode = ResultStore(args.data).meta.get("mode")
            if store_mode != args.pick_self:
                raise SystemExit(
                    f"--pick_stats indices are row numbers in the "
                    f"{args.pick_self!r} store, but --data points at a "
                    f"{store_mode!r} store: wrong scenarios would render")
            picks = pick_showcase_solves(args.pick_stats, args.pick_self,
                                         args.pick_other,
                                         args.pick_other_min)
        print(trajectories(args.data, args.out, args.n_mc, args.n_solves,
                           solve_indices=picks, device=args.device))
    else:
        print(animate(args.data, args.out, args.n_mc, args.solve_idx,
                      device=args.device))


if __name__ == "__main__":
    main()
