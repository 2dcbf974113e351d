"""Device resolution shared by every entry point.

Entry points default to ``"cuda"`` and never fall back to the CPU: a
caller that wants the CPU says so with ``device="cpu"``.  The ``meta``
device (shapes and dtypes, no storage, no launch) is accepted only inside
``dry_run()``, the dry run's tracing (``launch/dryrun.py``): nothing that
computes accepts it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

DEFAULT_DEVICE = "cuda"

_dry = threading.local()


@contextmanager
def dry_run():
    """Let ``resolve_device`` accept ``"meta"`` in the enclosed region."""
    prev = getattr(_dry, "on", False)
    _dry.on = True
    try:
        yield
    finally:
        _dry.on = prev


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """Validate ``device``; raise when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "meta" and getattr(_dry, "on", False):
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            f"(torch {torch.__version__}); pass device='cpu' to run the "
            f"plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
