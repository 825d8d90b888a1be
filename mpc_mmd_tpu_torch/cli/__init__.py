"""Command-line tools of the PyTorch port: ``sweep``, ``validate``,
``report`` and ``closedloop``, run as
``python -m mpc_mmd_tpu_torch.cli.<tool>``."""

import torch

from .. import device as _device


def resolve_device(name) -> torch.device:
    """The device a tool runs on.  A CUDA device without a card raises: a
    tool never carries on on the CPU in its place."""
    return _device.resolve_device(name, "--device cpu")
