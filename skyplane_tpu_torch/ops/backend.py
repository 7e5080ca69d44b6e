"""Device resolution: the port runs on CUDA unless the caller asks for the CPU.

There is no silent fallback: asking for CUDA on a host without a usable card
raises, so a measurement can never quietly run on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

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


def on_stream(stream: Optional["torch.cuda.Stream"]):
    """``torch.cuda.stream(stream)``, or nothing to enter for None (the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def record_event(stream: Optional["torch.cuda.Stream"]) -> Optional["torch.cuda.Event"]:
    """An event recorded on ``stream`` now; None for None (the CPU)."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event
