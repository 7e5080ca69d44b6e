"""Device resolution: the port runs on CUDA unless the caller asks for the CPU.

There is no silent fallback: asking for CUDA on a host without a usable card
raises, so a measurement can never quietly run on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``"cuda"`` (the default), ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is usable.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda.is_available() is false (pass device='cpu')")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; the port runs on 'cuda' or 'cpu'")
    return dev
