"""Integer-only CNN inference (port of ``repro.infer``)::

    params ──freeze──▶ FrozenModel ──compile_plan──▶ ExecutionPlan
                          │  ▲                       (stream_conv /
                save_frozen  load_frozen              nitro_matmul kernels)
                (JAX's format; QUANT_REPORT.json beside it)

``save_fleet_manifest`` / ``load_fleet_manifest`` describe a directory of
frozen models served as one fleet (``serving.ModelRegistry``).
"""

from repro_torch.infer.export import (  # noqa: F401
    FrozenLayer,
    FrozenModel,
    freeze,
    load_fleet_manifest,
    load_frozen,
    prune_frozen,
    quantization_report,
    save_fleet_manifest,
    save_frozen,
)
from repro_torch.infer.plan import ExecutionPlan, compile_plan  # noqa: F401
