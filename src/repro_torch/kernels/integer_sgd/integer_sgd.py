"""Python wrapper of the hand-written IntegerSGD CUDA kernel.

``integer_sgd_update`` replaces the Pallas ``integer_sgd_update``
(``_integer_sgd_kernel``): one IntegerSGD step,
``W − (⌊g/γ_inv⌋ + ⌊W/η_inv⌋)``, elementwise over a tensor of any shape,
reading W and g once and writing W′ once.

Source: ``csrc/integer_sgd.cu``, which notes the kernel's bound and
design.  The wrapper takes CUDA tensors only; ``ops.apply_tree_fused``
sends CPU tensors to the plain version in ``ref.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib


def integer_sgd_update(w: torch.Tensor, g: torch.Tensor, gamma_inv,
                       eta_inv) -> torch.Tensor:
    """One IntegerSGD step on the card: W′ of W's shape, int32.

    ``gamma_inv``/``eta_inv`` are the optimiser state's 0-d int32 tensors
    on the card (the kernel reads them there: no host sync) or ints;
    γ_inv must not be 0.
    """
    if w.shape != g.shape:
        raise ValueError(f"integer_sgd_update: w {tuple(w.shape)} and g "
                         f"{tuple(g.shape)} differ in shape")
    cuda_lib.require_cuda("integer_sgd_update", w, g)
    w, g = cuda_lib.as_int32("integer_sgd_update", w, g)
    if w.numel() >= 2 ** 31:
        raise ValueError("integer_sgd_update: tensor must have fewer than 2^31 elements")
    gamma = cuda_lib.sgd_scalar("gamma_inv", gamma_inv, w.device)
    eta = cuda_lib.sgd_scalar("eta_inv", eta_inv, w.device)
    out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    lib, launch = cuda_lib.entry("integer_sgd", "integer_sgd_launch", 5, 2)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(w.data_ptr(), g.data_ptr(), out.data_ptr(), gamma.data_ptr(),
                     eta.data_ptr(), w.numel(), cuda_lib.sm_count(w.device), stream)
    cuda_lib.check(lib, err, "integer_sgd_update")
    integer_sgd_update.launches.add()
    return out


#: launches of the CUDA kernel (the wrapper adds one per launch)
integer_sgd_update.launches = cuda_lib.LaunchCounter()
