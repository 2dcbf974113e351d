from repro_torch.kernels.nitro_conv.nitro_conv import stream_conv
from repro_torch.kernels.nitro_conv.ops import (
    CONV_MODES,
    fused_conv,
    resolve_conv_mode,
)
from repro_torch.kernels.nitro_conv.ref import (
    DEFAULT_BH,
    conv_geometry,
    stream_conv_ref,
)

__all__ = [
    "CONV_MODES",
    "DEFAULT_BH",
    "conv_geometry",
    "fused_conv",
    "resolve_conv_mode",
    "stream_conv",
    "stream_conv_ref",
]
