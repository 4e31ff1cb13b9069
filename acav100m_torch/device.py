"""Device resolution for the port's stage drivers.

Every driver config carries ``computation.device`` (default ``"cuda"``).
The default never degrades silently: asking for CUDA on a machine without a
CUDA device raises, so a run meant for the card cannot quietly run on the
CPU. Tests and CPU users pass ``computation.device=cpu``.
"""

from __future__ import annotations

import torch


def resolve_device(name=None) -> torch.device:
    """``computation.device`` value -> ``torch.device``; raises when CUDA is
    asked for and absent."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"computation.device={device} but no CUDA device is available; "
            "pass computation.device=cpu to run on the CPU"
        )
    return device
