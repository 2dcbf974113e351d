"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel package holds ``ref.py`` (the plain version), the kernel's
Python wrapper, ``ops.py`` (the dispatcher) and ``csrc/`` (CUDA C++).
Kernels are compiled with ``nvcc`` at first use (``cuda_lib``) and
loaded through ``ctypes``; nothing is built or imported at import time.
"""
