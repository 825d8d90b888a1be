# Frozen copy of mpc_mmd_tpu_torch/device.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""The device an entry point runs on.

The port's entry points (``Solver``, ``qp.build_workspace``,
``scenarios.static_grid``, ``scenarios.dynamic_cutin``) run on the CUDA card
unless the caller asks for the CPU.  Asking for a card where there is none
raises: nothing carries on on the CPU in its place.  :func:`to_device`
moves a solve's inputs there without a host synchronisation.
"""

from __future__ import annotations

import torch


def resolve_device(device, cpu_hint: str = 'device="cpu"') -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is no card.

    ``cpu_hint`` is how the caller asks for the CPU instead, named in the
    error (``device="cpu"`` for the library, ``--device cpu`` for the CLIs).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA card is available "
                           f"(pass {cpu_hint} to run on the CPU)")
    return dev


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; host data goes to the card through pinned memory
    without a host sync (PyTorch's caching host allocator keeps the pinned
    block until the copy has run)."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
