"""repro_torch — NITRO-D integer-only CNNs in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a), and the LM training path.

The package mirrors ``repro``'s module paths (``core``, ``kernels``,
``data``, ``infer``, ``serving``, ``launch``, ``models``, ``train``) so
each function has an obvious counterpart, and keeps ``repro``'s layouts
at every public function: NHWC activations, (K,K,C,F) conv weights,
(fan_in, fan_out) linear weights.  It imports torch and numpy only.

Entry points take an explicit ``device=`` that defaults to ``"cuda"``;
there is no silent CPU fallback (see ``device.resolve_device``).  On a
CPU tensor every kernel wrapper runs its plain PyTorch version, on a
CUDA tensor it launches the kernel or raises.
"""
