"""Kernels layer, #7 ``stream_conv_fwd`` (the training forward conv): its
roofline share over every launch a call makes (memset, x's and w's digit
planes, the digit GEMM).  The name table picks the GEMM by its epilogue."""

from perfbench import harness

GEMM = [("conv_digit_gemm_kernel", "FwdOut")]
PREPASS = [("x_digits_kernel",), ("patch_digits_kernel",), ("delta_digits_kernel",)]


def read(r, trace):
    return harness.roofline_pct(r, trace, "stream_conv_fwd", GEMM, PREPASS)
