"""Kernels layer, #6 ``stream_conv`` (the served conv with its fused pool):
its roofline share over every launch a call makes (memset, digit planes,
the digit GEMM).  The name table picks the GEMM by its epilogue."""

from perfbench import harness

GEMM = [("conv_digit_gemm_kernel", "ServeOut")]
PREPASS = [("x_digits_kernel",), ("patch_digits_kernel",), ("delta_digits_kernel",)]


def read(r, trace):
    return harness.roofline_pct(r, trace, "stream_conv", GEMM, PREPASS)
