"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    ``None`` means the card. Without CUDA that raises instead of falling
    back to the CPU quietly, so a run that was meant for the card can never
    report CPU numbers; pass ``device="cpu"`` to run on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host")
    return dev


def wait_for(stream: torch.cuda.Stream) -> None:
    """Block the calling thread until ``stream``'s queued work is done, on a
    blocking event. While a copy to pageable memory waits for a kernel,
    every other thread's CUDA call, a kernel launch too, waits with it:
    wait here first, then copy."""
    done = torch.cuda.Event(blocking=True)
    done.record(stream)
    done.synchronize()
