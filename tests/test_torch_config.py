"""The PyTorch port's configuration mirrors the JAX package's field for field."""

import dataclasses

import pytest
import torch

import mpc_mmd_tpu.config as jc
import mpc_mmd_tpu_torch.config as tc

torch.set_num_threads(1)


def _as_tree(cfg):
    """(class name, field dict) recursively, so class names are compared too."""
    if dataclasses.is_dataclass(cfg):
        return (type(cfg).__name__,
                {f.name: _as_tree(getattr(cfg, f.name))
                 for f in dataclasses.fields(cfg)})
    return cfg


@pytest.mark.parametrize("preset,kwargs", [
    ("static_workload", {}),
    ("static_workload", dict(num_reduced=4, num_obs=2, num_prime=20,
                             noise_level=0.3, acc_const_noise=0.02)),
    ("fastrt_workload", {}),
    ("fastrt_workload", dict(num_reduced=4, num_obs=2)),
    ("realtime_workload", {}),
    ("realtime_workload", dict(num_reduced=3, noise="beta", mode="cvar")),
    ("fast_workload", {}),
    ("fast_workload", dict(num_obs=2, noise_level=0.2, steer_const_noise=0.01)),
    ("dynamic_workload", {}),
    ("dynamic_workload", dict(num_reduced=10, num_obs=6, noise="beta",
                              noise_level=0.2, num_prime=50, mode="cvar")),
    ("dynamic_workload", dict(num_reduced=3, num_obs=2, num_prime=15,
                              noise="gaussian", mode="saa")),
    ("onroad_workload", {}),
    ("onroad_workload", dict(num_reduced=3, num_obs=2, num_prime=20, mode="cvar")),
    ("onroad_workload", dict(right_hand_lanes=False, noise="beta",
                             acc_const_noise=0.02, steer_const_noise=0.01)),
])
def test_presets_match_jax(preset, kwargs):
    assert _as_tree(getattr(tc, preset)(**kwargs)) == \
        _as_tree(getattr(jc, preset)(**kwargs))


def test_defaults_and_derived_values_match_jax():
    assert _as_tree(tc.ProblemConfig()) == _as_tree(jc.ProblemConfig())
    j, t = jc.fastrt_workload(), tc.fastrt_workload()
    assert t.horizon.dt == j.horizon.dt and t.horizon.nvar == j.horizon.nvar
    assert t.beta_cem.num_ellite == j.beta_cem.num_ellite == 7
    assert t.risk.num_mother == j.risk.num_mother == 100
    assert t.risk.weights() == j.risk.weights()
    assert tc.REALTIME_INNER_BUDGET == jc.REALTIME_INNER_BUDGET
    assert tc.FASTRT_OUTER_BUDGET == jc.FASTRT_OUTER_BUDGET
    assert tc.FAST_OUTER_BUDGET == jc.FAST_OUTER_BUDGET
    assert _as_tree(t.with_risk_mode("cvar")) == _as_tree(j.with_risk_mode("cvar"))


def test_validation():
    for kind in tc.KERNEL_KINDS:
        assert tc.RiskConfig(kernel=kind).kernel == kind
    from mpc_mmd_tpu.kernels import KERNEL_KINDS
    assert tc.KERNEL_KINDS == KERNEL_KINDS
    with pytest.raises(ValueError):
        tc.RiskConfig(kernel="cosine")
    with pytest.raises(ValueError):
        tc.RiskConfig(mode="bogus")
    with pytest.raises(ValueError):
        tc.NoiseConfig(kind="uniform")
