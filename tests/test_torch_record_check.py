"""The stage dump of ``mpc_mmd_tpu_torch/utils/record_check.py`` and what
it found at the record cell's seed 1163 (static gaussian 0.1, N = 10).

On the H100 the card's solve of seed 1163 leaves the CPU's at outer
iteration 3, on the card's own draws and on the CPU's draws replayed on
the card alike.  The first index tensor apart is an elite pick of the
inner CEM (outer iteration 1, inner iteration 3, the third top-k of
-cost, n_el = 11): two candidates' MMD costs lie within round-off of
their neighbours', and the card's and the CPU's costs, a few ulp apart
from the products upstream (cuBLAS and the CPU's BLAS sum in another
order), rank them the other way.  ``tests/data/seed1163_elite_pick.npz``
holds those two candidates' rows of -cost on both devices and each
device's picks (``tests/record_spot_check.py --port_seeds 1163 --dump``
on the card wrote them).
"""

import dataclasses
from pathlib import Path

import numpy as np
import torch

from mpc_mmd_tpu_torch.config import static_workload
from mpc_mmd_tpu_torch.ops import topk_indices
from mpc_mmd_tpu_torch.utils.record_check import _by_candidate, _compare, stage_dump

torch.set_num_threads(1)

DUMP = Path(__file__).resolve().parent / "data" / "seed1163_elite_pick.npz"


def test_seed_1163_inner_elite_pick_turns_on_a_near_tie():
    """The elite pick (top 11 of -cost) on each device's row gives that
    device's recorded picks; the rows are at most 4e-6 apart (under 6e-6
    of their values); and every sample picked on one side only, or at
    another rank, lies within 2.5e-6 (about 40 ulp) of the sample it swaps
    with, on both devices: a near-tie that the products' round-off
    decides."""
    with np.load(DUMP) as f:
        d = dict(f)
    card, cpu = d["card_neg_cost"], d["cpu_neg_cost"]
    n_el = d["card_elites"].shape[1]
    for row, picks in ((card, d["card_elites"]), (cpu, d["cpu_elites"])):
        got = topk_indices(torch.as_tensor(row), n_el).numpy()
        assert np.array_equal(got, picks)
    gap = np.abs(card - cpu)
    assert gap.max() <= 4e-6 and (gap / np.abs(cpu)).max() <= 6e-6
    assert not np.array_equal(d["card_elites"], d["cpu_elites"])
    for i in range(len(d["candidates"])):
        a, b = d["card_elites"][i], d["cpu_elites"][i]
        for slot in np.nonzero(a != b)[0]:
            for row in (card[i], cpu[i]):
                assert abs(row[a[slot]] - row[b[slot]]) <= 2.5e-6, (i, slot)


def _small_cfg():
    cfg = static_workload(num_reduced=3, num_obs=6, noise="gaussian", noise_level=0.1,
                          num_prime=50, mode="mmd_opt")
    return cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=24),
                       beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                                    maxiter=3))


def test_stage_dump_of_the_cpu_against_itself_finds_nothing(tmp_path):
    """Two CPU runs of seed 1163 at a small width, on their own draws and
    on replayed draws: every stage equal, nothing apart, the same costs;
    the small tensors land in the .npz under each device's name."""
    for draws in ("own", "cpu"):
        npz = tmp_path / f"{draws}.npz"
        d = stage_dump(1163, ("cpu", "cpu"), draws, 3, _small_cfg(), npz=str(npz))
        assert d["first_float_apart"] is None and d["first_index_apart"] is None
        assert d["res_departs_at"] is None and d["res"]["cpu"] and len(d["res"]["cpu"]) == 3
        stages = [s["stage"] for s in d["stages"]]
        for stage in ("it1 compute_guess#1.0", "it1 project#1.res_norm", "it1 argsort#1",
                      "it2 topk_indices#2", "it2 eq_qp_solve#1.in.0", "it3 cem_update#1.0"):
            assert stage in stages
        assert not any(s.get("gap", 0.0) or s.get("n_apart", 0) for s in d["stages"])
        with np.load(npz) as f:
            assert "cpu/it3 argsort#2" in f.files


def test_by_candidate_undoes_the_residual_order():
    """Two devices whose residual sorts order the same candidates
    differently compare equal candidate by candidate, their risk sorts as
    the candidates they rank; ``_compare`` counts what is left."""
    nb, M = 4, 3
    vals = torch.arange(nb * 5, dtype=torch.float32).view(1, nb, 5)
    refit = torch.arange(nb * M * 2, dtype=torch.float32).view(nb * M, 2)
    recs = []
    for perm in (torch.tensor([2, 0, 3, 1]), torch.tensor([0, 1, 2, 3])):
        risk_order = torch.argsort(perm)[None]               # ranks candidate 0 first
        recs.append(_by_candidate([
            ("it1 argsort#1", perm[None]),
            ("it1 noisy_controls#1.0", vals[:, perm]),
            ("it1 refit_coefficients#1.0",
             refit.view(nb, M, 2)[perm].reshape(nb * M, 2)),
            ("it1 argsort#2", risk_order)], nb))
    (_, p0), *rest0 = recs[0]
    (_, p1), *rest1 = recs[1]
    assert _compare(p0, p1)["n_apart"] == 4
    for (k0, a), (k1, b) in zip(rest0, rest1):
        assert k0 == k1 and torch.equal(a, b), k0
    c = _compare(torch.tensor([1.0, 2.0, float("nan")]), torch.tensor([1.0, 2.5, float("nan")]))
    assert (c["gap"], c["n_apart"], c["n_differ"]) == (0.5, 1, 1)
