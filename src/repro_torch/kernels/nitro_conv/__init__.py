from repro_torch.kernels.nitro_conv.nitro_conv import (
    stream_conv,
    stream_conv_fwd,
    stream_conv_grad_w,
    stream_conv_grad_w_opt,
    stream_conv_grad_x,
)
from repro_torch.kernels.nitro_conv.ops import (
    CONV_MODES,
    conv_grad_w,
    conv_grad_w_opt,
    conv_grad_x,
    fused_conv,
    fused_conv_fwd,
    resolve_conv_mode,
)
from repro_torch.kernels.nitro_conv.ref import (
    DEFAULT_BH,
    conv_geometry,
    rot180_swap,
    stream_conv_fwd_ref,
    stream_conv_grad_w_opt_ref,
    stream_conv_grad_w_ref,
    stream_conv_grad_x_ref,
    stream_conv_ref,
)

__all__ = [
    "CONV_MODES",
    "DEFAULT_BH",
    "conv_geometry",
    "conv_grad_w",
    "conv_grad_w_opt",
    "conv_grad_x",
    "fused_conv",
    "fused_conv_fwd",
    "resolve_conv_mode",
    "rot180_swap",
    "stream_conv",
    "stream_conv_fwd",
    "stream_conv_fwd_ref",
    "stream_conv_grad_w",
    "stream_conv_grad_w_opt",
    "stream_conv_grad_w_opt_ref",
    "stream_conv_grad_w_ref",
    "stream_conv_grad_x",
    "stream_conv_grad_x_ref",
    "stream_conv_ref",
]
