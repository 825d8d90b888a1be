# Frozen copy of mpc_mmd_tpu_torch/config.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Configuration surface of the PyTorch port.

Frozen dataclasses that copy ``mpc_mmd_tpu/config.py`` field for field, so a
configuration means the same problem in both packages.  The JAX config is not
imported: its ``RiskConfig.__post_init__`` imports jax.

Every ``RiskConfig.kernel`` of the JAX package (laplace, gaussian,
matern52) is ported.  ``solve_strategy``,
``rollout_backend`` and ``matmul_precision`` keep their JAX fields and
defaults; :class:`mpc_mmd_tpu_torch.solver.Solver` says which values it runs
(every matmul of the port is full float32, see ``__init__``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

RISK_MODES = ("mmd_opt", "mmd_random", "cvar", "saa", "det")
NOISE_KINDS = ("gaussian", "beta")
KERNEL_KINDS = ("laplace", "gaussian", "matern52")


@dataclass(frozen=True)
class HorizonConfig:
    t_fin: float = 15.0
    num: int = 100
    num_prime: int = 50
    order: int = 10

    @property
    def dt(self) -> float:
        return self.t_fin / self.num

    @property
    def nvar(self) -> int:
        return self.order + 1


@dataclass(frozen=True)
class VehicleConfig:
    wheel_base: float = 2.5
    v_min: float = 0.1
    v_max: float = 30.0
    a_max: float = 18.0
    steer_max: float = 0.6
    steer_rate_max: float = 0.6
    kappa_max: float = 0.230
    a_centr: float = 1.5


@dataclass(frozen=True)
class ObstacleConfig:
    num_obs: int = 6
    a_obs: float = 4.25
    b_obs: float = 2.75
    num_circles: int = 1


@dataclass(frozen=True)
class LaneConfig:
    y_lb: float = -2.25
    y_ub: float = 2.25
    y_des_1: float = -1.75
    y_des_2: float = 1.75
    gamma: float = 1.0
    gamma_lane_des: float = 0.3


@dataclass(frozen=True)
class GuessConfig:
    k_p_v: float = 2.0
    k_p: float = 2.0
    rho_v: float = 1.0
    rho_offset: float = 1.0
    weight_smoothness_x: float = 100.0
    weight_smoothness_y: float = 100.0
    num_segments: int = 4


@dataclass(frozen=True)
class ProjectionConfig:
    maxiter: int = 1
    rho_ineq: float = 1.0
    rho_obs: float = 1.0
    rho_projection: float = 1.0
    rho_lane: float = 1.0
    gamma: float = 1.0
    gamma_obs: float = 1.0
    with_obstacle_terms: bool = False


@dataclass(frozen=True)
class CEMOuterConfig:
    num_batch: int = 100
    ellite_num: int = 5
    ellite_num_cost: int = 20
    maxiter_cem: int = 20
    alpha_mean: float = 0.6
    alpha_cov: float = 0.6
    lamda: float = 0.9
    cov_jitter: float = 0.01
    num_params: int = 8


@dataclass(frozen=True)
class BetaCEMConfig:
    num_samples_cem: int = 100
    maxiter: int = 20
    ellite_frac: float = 0.1
    init_cov_scale: float = 20.0
    cov_jitter: float = 0.05
    sigma_clip: float = 0.01
    rho_beta: float = 1.0
    qp_reg: float = 0.05

    @property
    def num_ellite(self) -> int:
        return max(int(self.ellite_frac * self.num_samples_cem) + 1, 3)


@dataclass(frozen=True)
class NoiseConfig:
    kind: str = "gaussian"
    level: float = 0.1
    acc_const: float = 0.0
    steer_const: float = 0.0
    beta_a: float = 2.0
    beta_b: float = 5.0
    k_steer: float = 0.01

    def __post_init__(self):
        if self.kind not in NOISE_KINDS:
            raise ValueError(f"noise kind must be one of {NOISE_KINDS}, got {self.kind!r}")


@dataclass(frozen=True)
class RiskConfig:
    mode: str = "mmd_opt"
    num_reduced: int = 10
    ker_wt: float = 1000.0
    sigma_ker: float = 10.0
    alpha_quant: float = 0.98
    alpha_quant_lane: float = 0.98
    weight_mmd_lane: float = 0.0
    weight_mmd_obs: float = 1.0e3
    weight_cvar_lane: float = 0.0
    weight_cvar_obs: float = 1.0e3
    weight_saa_lane: float = 1.0e6
    weight_saa_obs: float = 1.0e6
    weight_lane_des: float = 0.0
    kernel: str = "laplace"

    def __post_init__(self):
        if self.mode not in RISK_MODES:
            raise ValueError(f"risk mode must be one of {RISK_MODES}, got {self.mode!r}")
        if self.kernel not in KERNEL_KINDS:
            raise ValueError(f"kernel must be one of {KERNEL_KINDS}, "
                             f"got {self.kernel!r}")

    @property
    def num_mother(self) -> int:
        return self.num_reduced ** 2

    def weights(self) -> Tuple[float, float]:
        """(lane_weight, obs_weight) for the active mode."""
        return {
            "mmd_opt": (self.weight_mmd_lane, self.weight_mmd_obs),
            "mmd_random": (self.weight_mmd_lane, self.weight_mmd_obs),
            "cvar": (self.weight_cvar_lane, self.weight_cvar_obs),
            "saa": (self.weight_saa_lane, self.weight_saa_obs),
            "det": (0.0, 0.0),
        }[self.mode]


@dataclass(frozen=True)
class FrenetVariantConfig:
    init_mu: Tuple[float, float] = (0.3, 0.0)
    init_sigma: Tuple[float, float] = (0.05, 0.1)
    num_path: int = 600
    lookahead: float = 300.0
    smooth_threshold: float = 0.1
    weight_des_lane: float = 0.01
    weight_centr: float = 0.1
    num_mean_update: int = 4


@dataclass(frozen=True)
class ProblemConfig:
    horizon: HorizonConfig = HorizonConfig()
    vehicle: VehicleConfig = VehicleConfig()
    obstacles: ObstacleConfig = ObstacleConfig()
    lane: LaneConfig = LaneConfig()
    guess: GuessConfig = GuessConfig()
    projection: ProjectionConfig = ProjectionConfig()
    cem: CEMOuterConfig = CEMOuterConfig()
    beta_cem: BetaCEMConfig = BetaCEMConfig()
    noise: NoiseConfig = NoiseConfig()
    risk: RiskConfig = RiskConfig()
    frenet: FrenetVariantConfig = FrenetVariantConfig()
    solve_strategy: str = "prefactored"
    rollout_backend: str = "auto"
    matmul_precision: str = "default"

# Budgets of the JAX package's presets (mpc_mmd_tpu/config.py, where their
# quality certification is documented): (samples, iterations) of the inner
# beta-CEM, (candidates, iterations) of the outer CEM.
REALTIME_INNER_BUDGET = (64, 12)
FAST_OUTER_BUDGET = (64, 12)
FASTRT_OUTER_BUDGET = (64, 10)


def from_dict(d: dict) -> ProblemConfig:
    """A :class:`ProblemConfig` from its nested dict (``dataclasses.asdict``
    of one, as the benchmark's configuration files hold it); a group that is
    left out keeps its defaults."""
    groups = {f.name: f.type for f in dataclasses.fields(ProblemConfig)}
    kw = {}
    for name, value in d.items():
        if isinstance(value, dict):
            cls = globals()[groups[name]] if isinstance(groups[name], str) else groups[name]
            kw[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in value.items()})
        else:
            kw[name] = value
    return ProblemConfig(**kw)
