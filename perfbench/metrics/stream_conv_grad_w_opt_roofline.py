"""Kernels layer, #9 ``stream_conv_grad_w_opt`` (the conv weight gradient
with IntegerSGD in its flush): its roofline share over every launch a
call makes (memset, x's range, δ's and x's patch digit planes, the GEMM)."""

from perfbench import harness

GEMM = [("digit_gemm_kernel<true>",)]
PREPASS = [("x_range_kernel",), ("delta_digits_kernel",), ("patch_digits_kernel",)]


def read(r, trace):
    return harness.roofline_pct(r, trace, "stream_conv_grad_w_opt", GEMM, PREPASS)
