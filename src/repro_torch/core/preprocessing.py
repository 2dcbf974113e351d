"""Integer-only data pre-processing (port of ``repro.core.preprocessing``,
paper Appendix B.2).

    μ_int = ⌊ Σ x_i / N ⌋
    ω_int = ⌊ Σ |x_i − μ_int| / N ⌋
    x̂_i   = ⌊ (x_i − μ_int) · 51 / ω_int ⌋        (51 = ⌊64·0.8⌋)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import numerics

MAD_TARGET_MULTIPLIER = 51  # ⌊64 × 0.8⌋


def integer_statistics(x) -> tuple[int, int]:
    """(μ_int, ω_int) over the whole dataset, in numpy int64 on the host
    (dataset-level sums overflow int32)."""
    xi = np.asarray(x)
    if not np.issubdtype(xi.dtype, np.integer):
        raise TypeError(f"preprocess input must be integer, got {xi.dtype}")
    n = xi.size
    mu = int(np.sum(xi, dtype=np.int64) // n)
    omega = int(np.sum(np.abs(xi.astype(np.int64) - mu)) // n)
    return mu, omega


def normalize(x, mu: int, omega: int) -> torch.Tensor:
    """x̂ = ⌊(x − μ)·51 / ω⌋ in int32 (wrapping), with ω clamped ≥ 1."""
    omega = max(int(omega), 1)
    centred = torch.as_tensor(x).to(numerics.INT_DTYPE) - int(mu)
    return numerics.floor_div(centred * MAD_TARGET_MULTIPLIER, omega)


def preprocess(x) -> torch.Tensor:
    """Full pipeline: compute dataset statistics then normalise."""
    mu, omega = integer_statistics(x)
    return normalize(x, mu, omega)
