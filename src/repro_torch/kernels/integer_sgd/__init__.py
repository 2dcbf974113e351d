from repro_torch.kernels.integer_sgd.integer_sgd import (
    integer_sgd_update,
    integer_sgd_update_many,
)
from repro_torch.kernels.integer_sgd.ops import apply_groups_fused, apply_tree_fused
from repro_torch.kernels.integer_sgd.ref import integer_sgd_ref

__all__ = ["apply_groups_fused", "apply_tree_fused", "integer_sgd_ref", "integer_sgd_update",
           "integer_sgd_update_many"]
