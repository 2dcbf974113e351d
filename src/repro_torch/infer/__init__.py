"""Integer-only CNN inference (port of ``repro.infer``)::

    params ──freeze──▶ FrozenModel ──compile_plan──▶ ExecutionPlan
                          ▲                          (stream_conv /
      JAX save_frozen dir ┘ load_frozen               nitro_matmul kernels)
"""

from repro_torch.infer.export import (  # noqa: F401
    FrozenLayer,
    FrozenModel,
    freeze,
    load_frozen,
)
from repro_torch.infer.plan import ExecutionPlan, compile_plan  # noqa: F401
