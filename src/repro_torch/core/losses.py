"""Integer RSS loss (port of ``repro.core.losses``, paper §3.3, Eq. 1).

    L_l  = ½ (ŷ_l − y)²          (reported, integer)
    ∇L_l = ŷ_l − y               (used for training)

``y`` is the paper's one-hot with the true class at 32 (Appendix B.2).
"""

from __future__ import annotations

import torch

from repro_torch.core import numerics

ONE_HOT_VALUE = 32  # Appendix B.2


def one_hot_int(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-hot encode with value 32 at the true class, int32."""
    classes = torch.arange(num_classes, device=labels.device)
    eye = (labels[..., None] == classes).to(numerics.INT_DTYPE)
    return eye * ONE_HOT_VALUE


def rss_loss(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Integer loss Σ ⌊(ŷ−y)²/2⌋ over the batch, an int32 scalar (wraps)."""
    numerics.assert_int(y_hat, "rss y_hat")
    diff = y_hat - y
    return numerics.sum_int32(numerics.floor_div(diff * diff, 2))


def rss_grad(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """∇L = ŷ − y, elementwise integer subtraction."""
    numerics.assert_int(y_hat, "rss y_hat")
    numerics.assert_int(y, "rss y")
    return y_hat - y
