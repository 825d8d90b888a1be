"""The device an entry point runs on.

The port's entry points (``Solver``, ``qp.build_workspace``,
``scenarios.static_grid``, ``scenarios.dynamic_cutin``) run on the CUDA card
unless the caller asks for the CPU.  Asking for a card where there is none
raises: nothing carries on on the CPU in its place.
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
