"""The port's sweep -> Monte-Carlo validation -> report pipeline, and the
stores it shares with the JAX package.

Sweeps run at a tiny size (num_reduced 3, num_obs 2, num_prime 15, outer
CEM 16 x 2, inner 16 x 2) on the CPU.  Cross-package checks: the JAX
package's ResultStore and validate_store read a store the port wrote, the
port's validate_store reads a JAX-written one and, fed the JAX key chain's
draws, gives the JAX validator's counts exactly; with accept_all both
sweeps write the same tag, meta, seeds, initial states and obstacle
fields row for row (the solves themselves differ: their draws do).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_mmd_tpu.cli.sweep as j_sweep
import mpc_mmd_tpu.cli.validate as j_validate
from mpc_mmd_tpu.qp import build_workspace as j_build_workspace
from mpc_mmd_tpu.utils.io_store import ResultStore as JResultStore
from mpc_mmd_tpu_torch.cli import report, sweep, validate
from mpc_mmd_tpu_torch.config import static_workload
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.utils.io_store import ResultStore
from mpc_mmd_tpu_torch.utils.observability import (MetricLogger, device_trace,
                                                   phase_timer, trace_summary)
from test_torch_noise import JaxKeyChain
from test_torch_validate import jax_mc_draws

torch.set_num_threads(1)

TINY = dict(num_reduced=3, num_obs=2, num_prime=15, outer_budget=(16, 2))
FLAGS = ["--num_reduced_sets", "3", "--num_obs", "2", "--num_prime", "15",
         "--outer_budget", "16x2", "--inner_budget", "16x2", "--device", "cpu"]


def _sweep(out, mode="cvar", workload="static", noise="gaussian", **kw):
    args = dict(TINY, workload=workload, mode=mode, noise=noise,
                noise_level=0.2, num_configs=4, out_root=str(out), chunk=2,
                device="cpu")
    args.update(kw)
    return sweep.run_sweep(**args)


def test_cli_sweep_validate_report_end_to_end(tmp_path, capsys):
    """The three CLIs through their ``main``: a two-mode sweep, plain and
    --compare validation, the grid box plot."""
    out, stats = tmp_path / "data", tmp_path / "stats"
    sweep.main(["--costs", "mmd_opt", "cvar", "--noise_levels", "0.1",
                "--noises", "gaussian", "--num_configs", "4", "--chunk", "2",
                "--out", str(out), "--trace", str(tmp_path / "trace"), *FLAGS])
    printed = capsys.readouterr().out
    assert any(f.startswith("summary_") for f in os.listdir(tmp_path / "trace"))
    assert "cost=mmd_opt" in printed and "cost=cvar" in printed
    base = out / "static" / "gaussian_noise" / "noise_10" / "ts_15"
    roots = [str(base / f"{m}_S16x2_B16x2_3_samples_2_obs") for m in ("mmd_opt", "cvar")]
    assert all(os.path.exists(os.path.join(r, "manifest.json")) for r in roots)
    assert all(len(ResultStore(r).concatenated()["cx"]) >= 1 for r in roots)

    validate.main(["--data", roots[1], "--n_mc", "40", "--out",
                   str(tmp_path / "single"), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["n_mc"] == 40 and summary["n_solves"] >= 1
    with np.load(tmp_path / "single" / "validation.npz") as z:
        assert z["coll_count"].shape == (summary["n_solves"],)

    validate.main(["--data", *roots, "--compare", "--n_mc", "40", "--out",
                   str(stats), "--device", "cpu"])
    res = json.loads(capsys.readouterr().out)
    assert res["n_common"] >= 1 and set(res["modes"]) == {"mmd_opt", "cvar"}
    assert res["pairs"]["mmd_opt_vs_cvar"]["n"] == res["n_common"]
    with np.load(res["stats_path"]) as z:
        assert z["coll_mmd_opt"].shape == (res["n_common"],)
        assert int(z["n_mc"]) == 40 and "coll_cvar_lane" in z and "idx_cvar" in z

    pytest.importorskip("matplotlib")
    fig = str(tmp_path / "grid.png")
    report.main(["grid", "--stats_root", str(stats), "--noise_levels", "0.1",
                 "--num_reduced_sets", "3", "--num_obs", "2", "--num_prime",
                 "15", "--n_mc", "40", "--out", fig])
    assert os.path.getsize(fig) > 0


def test_sweep_resumes_finished_chunks(tmp_path, monkeypatch):
    """A rerun solves nothing; a sweep grown from 4 to 6 configs solves
    only the new chunk, and the store's extent grows with it."""
    store = _sweep(tmp_path)
    before = store.concatenated()
    calls = []
    orig = sweep.Solver.solve

    def counting(self, *a, **k):
        calls.append(a[0])
        return orig(self, *a, **k)

    monkeypatch.setattr(sweep.Solver, "solve", counting)
    again = _sweep(tmp_path)
    assert calls == [] and again.done_chunks() == [0, 1]
    grown = _sweep(tmp_path, num_configs=6)
    seeds = np.random.RandomState(0).randint(1, 10000, size=6)
    assert calls == [int(s) for s in seeds[4:]]
    assert grown.done_chunks() == [0, 1, 2] and grown.meta["num_configs"] == 6
    np.testing.assert_array_equal(grown.read_chunk(0)["cx"],
                                  ResultStore(store.root).read_chunk(0)["cx"])
    assert len(before["cx"]) <= len(grown.concatenated()["cx"])


def test_sweep_store_layout_matches_jax(tmp_path):
    """accept_all sweeps of both packages: same store tag and meta, and the
    same seeds, initial states and obstacle fields row for row; then each
    package validates the other's store."""
    kw = dict(workload="static", mode="cvar", noise="gaussian",
              noise_level=0.29, num_configs=3, chunk=2, accept_all=True,
              inner_budget=(16, 2), kernel="gaussian", **TINY)
    t_store = sweep.run_sweep(out_root=str(tmp_path / "t"), device="cpu", **kw)
    j_store = j_sweep.run_sweep(out_root=str(tmp_path / "j"), **kw)
    rel = lambda s, root: os.path.relpath(s.root, str(tmp_path / root))
    assert rel(t_store, "t") == rel(j_store, "j")
    assert "noise_29" in rel(t_store, "t") and rel(t_store, "t").endswith(
        "cvar_S16x2_B16x2_Kgaussian_all_3_samples_2_obs")
    assert t_store.meta == j_store.meta
    t, j = t_store.concatenated(), JResultStore(t_store.root).concatenated()
    ref = j_store.concatenated()
    assert set(t) == set(ref)
    for name in ("seeds", "init_state", "x_obs", "y_obs", "vx_obs", "vy_obs",
                 "psi_obs", "x_obs_traj", "y_obs_traj"):
        np.testing.assert_array_equal(t[name], ref[name], err_msg=name)
        assert t[name].dtype == ref[name].dtype, name
    for name in t:
        np.testing.assert_array_equal(j[name], t[name])   # JAX reads the port's
    assert t["cx"].dtype == np.float32 and np.all(np.isfinite(t["cx"]))

    # the JAX validator on the port's store, and the port's validator on the
    # JAX store fed the JAX draws: the same counts
    j_stats = j_validate.validate_store(t_store.root, n_mc=30,
                                        out_root=str(tmp_path / "js"))
    assert j_stats["n_solves"] == 3
    cfg = validate.config_of(j_store.meta)
    from mpc_mmd_tpu import config as jc
    jcfg = jc.static_workload(num_reduced=3, num_obs=2, num_prime=15,
                              noise="gaussian", noise_level=0.29)
    jws = j_build_workspace(jcfg)
    draws = jax_mc_draws(jcfg, jws, jnp.asarray(ref["cx"]), jnp.asarray(ref["cy"]),
                         0, 30)
    t_stats = validate.validate_store(j_store.root, n_mc=30,
                                      out_root=str(tmp_path / "ts"), device="cpu",
                                      noise=FixedNoise(draws, "cpu"))
    j_own = j_validate.validate_store(j_store.root, n_mc=30,
                                      out_root=str(tmp_path / "jj"))
    assert cfg.noise.level == 0.29
    for name in ("coll_count", "lane_count", "coll_fraction"):
        assert t_stats[name] == j_own[name], name
    for name in ("coll_pct_mean", "coll_pct_p50", "coll_pct_p95", "n_solves"):
        assert t_stats[name] == j_own[name], name
    with np.load(tmp_path / "ts" / "validation.npz") as a, \
            np.load(tmp_path / "jj" / "validation.npz") as b:
        assert set(a.files) == set(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
            assert a[name].dtype == b[name].dtype, name


@pytest.mark.parametrize("mode", ["mmd_opt", "cvar"])
def test_sweep_accepts_as_jax_on_jax_draws(tmp_path, monkeypatch, mode):
    """Fed the JAX key chain's draws, the port's sweep accepts exactly the
    scenarios the JAX sweep accepts, with the same risks (rtol 1e-4).  The
    scenarios are chosen so that some pass the threshold and some do not.
    With its own draws the port accepts other scenarios: a sweep's
    acceptance turns on the draws (ROADMAP.md Queue 3)."""
    kw = dict(workload="static", mode=mode, noise="gaussian", noise_level=0.1,
              num_reduced=3, num_obs=6, num_prime=50, num_configs=8, chunk=4,
              accept_all=True, inner_budget=(16, 2), outer_budget=(16, 4))
    ref = j_sweep.run_sweep(out_root=str(tmp_path / "j"), **kw).concatenated()
    solver = sweep.Solver
    monkeypatch.setattr(sweep, "Solver", lambda cfg, **k: solver(
        cfg, noise=JaxKeyChain(cfg), **k))
    got = sweep.run_sweep(out_root=str(tmp_path / "t"), device="cpu",
                          **kw).concatenated()
    threshold = sweep.accept_threshold(mode, static_workload().risk.ker_wt)
    accepted = ref["risk_obs"] <= threshold
    assert 0 < accepted.sum() < len(accepted)
    np.testing.assert_array_equal(got["seeds"], ref["seeds"])
    np.testing.assert_array_equal(got["risk_obs"] <= threshold, accepted)
    np.testing.assert_allclose(got["risk_obs"], ref["risk_obs"], rtol=1e-4,
                               atol=1e-3)


def test_validate_compare_matches_jax_stats_layout(tmp_path):
    """validate_compare on two JAX-written stores with the JAX draws: the
    stats npz and its sidecar equal the JAX package's, row for row."""
    stores = []
    for mode in ("cvar", "saa"):
        s = JResultStore(str(tmp_path / "data" / mode), meta={
            "workload": "static", "mode": mode, "noise": "gaussian",
            "noise_level": 0.3, "num_reduced": 3, "num_obs": 2,
            "num_prime": 15, "num_configs": 5})
        rng = np.random.default_rng(len(mode))
        t = np.linspace(0.0, 15.0, 100)
        rows = rng.permutation(5)[:4]
        n = len(rows)
        jws = j_build_workspace(validate.config_of(s.meta))
        P = np.asarray(jws.P, np.float64)
        cx = np.stack([np.linalg.lstsq(P, (5 + 0.3 * r) * t, rcond=None)[0]
                       for r in rows]).astype(np.float32)
        cy = np.stack([np.linalg.lstsq(P, 1.75 - 0.05 * r * t, rcond=None)[0]
                       for r in rows]).astype(np.float32)
        x0 = np.stack([[11.0 + r, 300.0] for r in rows]).astype(np.float32)
        y0 = np.tile(np.float32([-0.6, -1.75]), (n, 1))
        s.write_chunk(0, cx=cx, cy=cy,
                      init_state=np.tile(np.float32([0, 1.75, 5, 0, 0, 0]), (n, 1)),
                      x_obs=x0, y_obs=y0, vx_obs=np.zeros_like(x0),
                      vy_obs=np.zeros_like(x0), psi_obs=np.zeros_like(x0),
                      x_obs_traj=np.repeat(x0[:, :, None], 100, 2),
                      y_obs_traj=np.repeat(y0[:, :, None], 100, 2),
                      risk_obs=np.zeros(n, np.float32), seeds=rows)
        stores.append(s)
    roots = [s.root for s in stores]
    ref = j_validate.validate_compare(roots, n_mc=60, out_root=str(tmp_path / "j"))
    assert ref["n_common"] == 3
    arrays = [s.concatenated() for s in stores]
    joins = validate.intersect_stores(arrays, 2)
    jcfg = j_validate.static_workload(num_reduced=3, num_obs=2, num_prime=15,
                                      noise="gaussian", noise_level=0.3)
    jws = j_build_workspace(jcfg)
    draws = jax_mc_draws(jcfg, jws, jnp.asarray(arrays[0]["cx"][joins[0]]),
                         jnp.asarray(arrays[0]["cy"][joins[0]]), 0, 60)
    got = validate.validate_compare(roots, n_mc=60, out_root=str(tmp_path / "t"),
                                    device="cpu", noise=FixedNoise(draws, "cpu"))
    with np.load(got["stats_path"]) as a, np.load(ref["stats_path"]) as b:
        assert set(a.files) == set(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert np.any(np.load(got["stats_path"])["coll_cvar"] > 0)
    strip = lambda d: {k: v for k, v in d.items() if k != "stats_path"}
    assert strip(got) == strip(ref)
    with pytest.raises(ValueError, match="duplicate labels"):
        validate.validate_compare([roots[0], roots[0]], n_mc=10, device="cpu",
                                  out_root=str(tmp_path / "d"))
    with pytest.raises(ValueError, match="store mismatch"):
        other = ResultStore(str(tmp_path / "other"), meta=dict(
            stores[0].meta, num_prime=20))
        validate.validate_compare([roots[0], other.root], n_mc=10, device="cpu",
                                  out_root=str(tmp_path / "d"))


def test_paired_stats_and_intersect_stores_equal_jax():
    rng = np.random.default_rng(3)
    base = rng.poisson(30, size=80).astype(float)
    for b in (base + rng.poisson(8, size=80), base.copy(),
              base + rng.normal(0, 0.5, 80).round()):
        assert validate.paired_stats(base, b) == j_validate.paired_stats(base, b)
    with pytest.raises(ValueError):
        validate.paired_stats(base, base[:-1])

    def arrays(rows):
        r = np.asarray(rows, np.float64)[:, None]
        return {"init_state": np.tile(np.arange(6.0), (len(rows), 1)),
                "x_obs": np.hstack([r, r + 1.0]), "y_obs": np.hstack([-r, r]),
                "vx_obs": np.zeros((len(rows), 2)), "vy_obs": np.zeros((len(rows), 2))}

    sets = [arrays([0, 1, 2, 5]), arrays([1, 3, 2, 1, 5]), arrays([5, 2, 1])]
    for got, ref in zip(validate.intersect_stores(sets, 2),
                        j_validate.intersect_stores(sets, 2)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    assert validate.scenario_keys(sets[0], 2) == j_validate.scenario_keys(sets[0], 2)


def test_dynamic_sweep_with_beta_noise(tmp_path):
    """A dynamic-workload sweep: the port's cut-in trajectories, Beta noise
    and k_steer 0.05, validated on the CPU."""
    store = _sweep(tmp_path, mode="cvar", workload="dynamic", noise="beta",
                   accept_all=True)
    a = store.concatenated()
    assert len(a["cx"]) == 4 and np.all(np.isfinite(a["cx"]))
    xt = a["x_obs_traj"]
    assert np.any(np.abs(xt[..., -1] - xt[..., 0]) > 1.0)
    stats = validate.validate_store(store.root, n_mc=40, device="cpu",
                                    out_root=str(tmp_path / "stats"))
    assert stats["n_solves"] == 4 and 0.0 <= stats["coll_pct_mean"] <= 100.0


def test_cuda_without_a_card_fails(tmp_path):
    """--device cuda never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sweep.main(["--costs", "cvar", "--noise_levels", "0.1", "--noises",
                    "gaussian", "--num_reduced_sets", "3", "--num_obs", "2",
                    "--num_prime", "15", "--num_configs", "2",
                    "--out", str(tmp_path)])
    store = _sweep(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        validate.main(["--data", store.root, "--n_mc", "10"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        validate.validate_compare([store.root, store.root], labels=["a", "b"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        report.main(["trajectories", "--data", store.root, "--out",
                     str(tmp_path / "t.png")])


def test_unported_options_raise(tmp_path):
    for kw in (dict(dispatch="mesh"), dict(heartbeat_every=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            _sweep(tmp_path, **kw)
    with pytest.raises(ValueError):
        _sweep(tmp_path, dispatch="bogus")
    with pytest.raises(NotImplementedError, match="Distribution and operations"):
        validate.validate_store(str(tmp_path), mesh=True, device="cpu")


@pytest.mark.parametrize("mode", ["mmd_opt", "cvar"])
def test_batch_dispatch_writes_the_pipeline_store(tmp_path, monkeypatch, mode):
    """--dispatch batch at scenario_chunk 2 (chunks of 3, so a short last
    scenario chunk) solves each chunk in outer loops over 2 scenarios and
    stores what the per-scenario pipeline stores: the same seeds accepted,
    cx and cy within 1e-5 of their scale; the pipeline calls
    ``Solver.solve`` once per scenario, the batch dispatch never."""
    calls = []
    orig = sweep.Solver.solve

    def counting(self, *a, **k):
        calls.append(a[0])
        return orig(self, *a, **k)

    monkeypatch.setattr(sweep.Solver, "solve", counting)
    kw = dict(mode=mode, num_configs=5, chunk=3, inner_budget=(16, 2))
    ref = _sweep(tmp_path / "p", dispatch="pipeline", **kw).concatenated()
    assert len(calls) == 5
    store = _sweep(tmp_path / "b", dispatch="batch", scenario_chunk=2, **kw)
    assert len(calls) == 5 and store.done_chunks() == [0, 1]
    got = store.concatenated()
    assert set(got) == set(ref) and len(ref["seeds"]) >= 1
    np.testing.assert_array_equal(got["seeds"], ref["seeds"])
    for name in ("cx", "cy", "risk_obs"):
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_report_renders_from_port_stats(tmp_path):
    pytest.importorskip("matplotlib")
    roots = [_sweep(tmp_path / "data", mode=m).root for m in ("cvar", "saa")]
    res = validate.validate_compare(roots, n_mc=20, device="cpu",
                                    out_root=str(tmp_path / "stats"))
    assert res["n_common"] >= 1
    single = str(tmp_path / "single")
    validate.validate_store(roots[0], n_mc=20, out_root=single, device="cpu")
    assert os.path.exists(report.boxplot([single], ["cvar"], 20,
                                         str(tmp_path / "box.png")))
    assert os.path.exists(report.grid_boxplot(
        str(tmp_path / "stats"), "gaussian", [0.2], [3], 2, 15, 20,
        str(tmp_path / "grid.png"), modes=("cvar", "saa")))
    picks = report.pick_showcase_solves(res["stats_path"], "cvar", "saa",
                                        other_min=0, self_max=10 ** 9)
    assert len(picks) == res["n_common"]
    assert os.path.exists(report.trajectories(
        roots[0], str(tmp_path / "traj.png"), n_mc=10, n_solves=2,
        solve_indices=picks, device="cpu"))
    assert report.animate(roots[0], str(tmp_path / "a.gif"), n_mc=10,
                          device="cpu").endswith("a.gif")
    out, _ = report._animation_writer(str(tmp_path / "ep.gif"), fps=5)
    assert out.endswith("ep.gif")


def test_boxplot_tick_labels_fallback():
    """matplotlib before 3.9 has no ``tick_labels``: the port falls back to
    ``labels``."""
    class OldAxes:
        def boxplot(self, data, labels=None, showmeans=False):
            return ("labels", labels, showmeans)

    class NewAxes:
        def boxplot(self, data, tick_labels=None, showmeans=False):
            return ("tick_labels", tick_labels, showmeans)

    assert report.labelled_boxplot(OldAxes(), [[1]], ["a"], showmeans=True) == \
        ("labels", ["a"], True)
    assert report.labelled_boxplot(NewAxes(), [[1]], ["a"], showmeans=True) == \
        ("tick_labels", ["a"], True)


@pytest.mark.parametrize("cls", [ResultStore, JResultStore])
def test_result_store_semantics(tmp_path, cls):
    """The port's ResultStore behaves as the JAX package's: resume, extent
    growth, mix refusal, per-process shards, merged reads."""
    root = str(tmp_path / "s")
    meta = {"mode": "cvar", "num_configs": 200}
    s0 = cls(root, meta=meta, process_id=0, num_processes=2)
    s1 = cls(root, meta=meta, process_id=1, num_processes=2)
    s0.write_chunk(0, a=np.zeros(2))
    assert s0.is_done(0) and not s0.is_done(1)
    s1.write_chunk(1, a=np.ones(3))
    assert s0.is_done(1)                 # peer manifest, through the cache
    s1.write_chunk(3, a=np.full(1, 3.0))
    assert s0.is_done(3) and s0.done_chunks() == [0, 1, 3]
    with pytest.raises(ValueError):
        s0.write_chunk(1, a=np.zeros(1))
    assert {"manifest.json", "manifest_p001.json", "chunk_00000.npz",
            "chunk_p001_00001.npz"} <= set(os.listdir(root))
    np.testing.assert_array_equal(s1.concatenated()["a"], [0, 0, 1, 1, 1, 3])
    grown = cls(root, meta=dict(meta, num_configs=600))
    assert grown.meta["num_configs"] == 600 and grown.is_done(0)
    assert cls(root, meta=dict(meta, num_configs=100)).meta["num_configs"] == 600
    with pytest.raises(ValueError):
        cls(root, meta={"mode": "saa", "num_configs": 600})
    with pytest.raises(ValueError):
        cls(root, meta=meta, process_id=2, num_processes=2)
    other = ResultStore if cls is JResultStore else JResultStore
    np.testing.assert_array_equal(other(root).read_chunk(3)["a"], [3.0])


def test_observability(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = MetricLogger(path)
    with phase_timer(logger, "work", tag=1):
        pass
    logger.log("solve", cost=np.float32(1.5), t=torch.tensor([2.0]))
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["event"] == "phase" and recs[0]["phase"] == "work"
    assert recs[0]["tag"] == 1 and recs[0]["seconds"] >= 0.0
    assert recs[1]["cost"] == pytest.approx(1.5) and recs[1]["t"] == [2.0]
    assert len(logger.records("phase")) == 1
    trace_dir = str(tmp_path / "trace")
    with device_trace(trace_dir):
        torch.ones(4).sum()
    files = sorted(os.listdir(trace_dir))
    assert [f.split("_")[0] for f in files] == ["summary", "trace"]
    with open(os.path.join(trace_dir, files[0])) as f:
        summary = json.load(f)
    assert summary["device_events"] == 0 and summary["idle_share"] == 1.0
    with device_trace(None):
        pass


def test_trace_summary_takes_the_union_of_device_intervals():
    """Overlapping kernels (two streams) count once in the busy time."""
    from types import SimpleNamespace as NS
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, lo, hi, device=cuda):
        return NS(name=name, device_type=device, time_range=NS(
            start=lo, end=hi, elapsed_us=lambda: hi - lo))

    prof = NS(events=lambda: [event("a", 0, 10), event("b", 5, 15),
                              event("a", 20, 30), event("host", 0, 100, cpu)])
    out = trace_summary(prof, wall_s=100e-6)
    assert out["device_busy_ms"] == pytest.approx(0.025)
    assert out["idle_share"] == pytest.approx(0.75)
    assert out["device_events"] == 3
    assert out["top"] == [["a", 0.02, 2], ["b", 0.01, 1]]
