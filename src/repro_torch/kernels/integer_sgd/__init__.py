from repro_torch.kernels.integer_sgd.integer_sgd import integer_sgd_update
from repro_torch.kernels.integer_sgd.ops import apply_tree_fused
from repro_torch.kernels.integer_sgd.ref import integer_sgd_ref

__all__ = ["apply_tree_fused", "integer_sgd_ref", "integer_sgd_update"]
