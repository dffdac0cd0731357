"""Device selection and completion fences.

Counterpart of ``gravity_tpu/utils/platform.py`` and of ``sync`` in
``gravity_tpu/utils/timing.py``. Every entry point of the package runs
on the card unless its caller asks for the CPU, and :func:`resolve_device`
is the one place that rule lives: with no card and no explicit ``cpu``
it raises. It never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (error when there
    is none); ``"cpu"`` -> the CPU; any other torch device string as is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; gravity_tpu_torch runs on the GPU "
                "unless asked for the CPU (device='cpu', or --device cpu "
                "on the command line)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sync(device: Optional[torch.device] = None) -> None:
    """Wait for the device's queued work; a no-op on the CPU. Every
    wall-clock timing of device work ends with this fence."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
