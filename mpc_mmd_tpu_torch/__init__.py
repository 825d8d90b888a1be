"""PyTorch port of the risk-aware MPC-MMD engine, for an NVIDIA H100.

Beside the JAX package ``mpc_mmd_tpu``, which stays the reference; module
names mirror it.  This package imports torch and never jax.

TF32 is switched off for matmuls and cuDNN on import.  TF32 keeps about
three decimal digits, and the solve relies on values passing through
unchanged: the inner CEM carries its elite rows and their selection results
across iterations, and candidate order is decided by sorts of risks that
differ in the fourth digit.  Every matmul of the port is full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (ProblemConfig, fastrt_workload,  # noqa: E402
                     static_workload)
from .solver import SolveResult, Solver  # noqa: E402

__all__ = ["ProblemConfig", "Solver", "SolveResult", "fastrt_workload",
           "static_workload"]
