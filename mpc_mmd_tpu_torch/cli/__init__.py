"""Command-line tools of the PyTorch port: ``sweep``, ``validate`` and
``report``, run as ``python -m mpc_mmd_tpu_torch.cli.<tool>``."""

import torch


def resolve_device(name) -> torch.device:
    """The device a tool runs on.  A CUDA device without a card raises: a
    tool never carries on on the CPU in its place."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(name)!r}: no CUDA card is available "
                           "(pass --device cpu to run on the CPU)")
    return dev
