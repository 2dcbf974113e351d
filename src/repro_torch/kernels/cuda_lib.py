"""Build, load and launch-count the hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``_build/``
(git-ignored, next to this module) at first use, then loaded with
``ctypes``.  The library name carries a hash of the source, the shared
headers and the flags, so an edited kernel is rebuilt and a stale one is
never loaded.  ``build_all`` starts one ``nvcc`` per missing library and
waits for all of them, so a cold start pays for the slowest build only.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
COMMON_HEADERS = (
    _HERE / "csrc_common" / "nitro_epilogue.cuh",
    _HERE / "csrc_common" / "digit_gemm.cuh",
    _HERE / "csrc_common" / "conv_digits.cuh",
    _HERE / "csrc_common" / "linear_grad_w.cuh",
    _HERE / "csrc_common" / "split_matmul.cuh",
    _HERE / "csrc_common" / "wgmma_s8.cuh",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-I", str(_HERE / "csrc_common"),
)

#: library name → its CUDA source.  ``nitro_matmul`` also holds the
#: training forward ``nitro_matmul_fwd`` and ``maxpool`` both pool kernels;
#: every other kernel is a library of its own.
SOURCES = {
    "nitro_matmul": _HERE / "nitro_matmul" / "csrc" / "nitro_matmul.cu",
    "nitro_matmul_grad_w": _HERE / "nitro_matmul" / "csrc" / "nitro_matmul_grad_w.cu",
    "nitro_matmul_grad_w_opt":
        _HERE / "nitro_matmul" / "csrc" / "nitro_matmul_grad_w_opt.cu",
    "nitro_matmul_grad_x": _HERE / "nitro_matmul" / "csrc" / "nitro_matmul_grad_x.cu",
    "stream_conv": _HERE / "nitro_conv" / "csrc" / "stream_conv.cu",
    "stream_conv_fwd": _HERE / "nitro_conv" / "csrc" / "stream_conv_fwd.cu",
    "stream_conv_grad_w": _HERE / "nitro_conv" / "csrc" / "stream_conv_grad_w.cu",
    "stream_conv_grad_w_opt":
        _HERE / "nitro_conv" / "csrc" / "stream_conv_grad_w_opt.cu",
    "stream_conv_grad_x": _HERE / "nitro_conv" / "csrc" / "stream_conv_grad_x.cu",
    "integer_sgd": _HERE / "integer_sgd" / "csrc" / "integer_sgd.cu",
    "int_matmul": _HERE / "int_matmul" / "csrc" / "int_matmul.cu",
    "maxpool": _HERE / "maxpool" / "csrc" / "maxpool.cu",
}

#: Output tile (64 × 64) of the split-K matmul digit GEMMs, which keep one
#: arrival counter per tile: the forward matmuls and ``int_matmul``
#: (``TN``/``TM`` in split_matmul.cuh) and ``nitro_matmul_grad_x``
#: (``TM``/``TB`` in nitro_matmul_grad_x.cu).
GEMM_TILE = 64
#: Output tile (rows, cols) of the digit GEMMs of digit_gemm.cuh (``BM``/
#: ``BN``): the conv grad_W kernels (``stream_conv_grad_w_opt`` keeps one
#: counter per tile), the linear ones (linear_grad_w.cuh) and the conv
#: GEMM of conv_digits.cuh (the forward convs, ``stream_conv_grad_x``).
DIGIT_TILE = (128, 64)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_workspaces: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


class LaunchCounter:
    """Thread-safe count of kernel launches (the wrapper adds one per launch)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else in PyTorch's CUDA home."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME and cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin); the CUDA "
        "kernels are compiled at first use and need the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in (SOURCES[name], *COMMON_HEADERS):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library in parallel; returns name → nvcc log.

    Raises ``RuntimeError`` with the compiler output if any build fails.
    """
    names = list(SOURCES if names is None else names)
    with _lock:
        jobs = {n: _start_build(n) for n in names if not _lib_path(n).exists()}
        logs, failed = {}, []
        for n, (proc, tmp, out) in jobs.items():
            logs[n], _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(n)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half a .so
            (BUILD_DIR / f"{n}.log").write_text(logs[n])
    if failed:
        detail = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(path))
            lib.nitro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nitro_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return _loaded[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = lib.nitro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def entry(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int):
    """``(lib, fn)``: library ``lib_name`` (built on first use) and its C
    entry point ``fn_name``, typed as ``n_ptrs`` pointers, ``n_ints`` ints
    and the stream, returning a ``cudaError_t``."""
    lib = load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (sizes split-K grids),
    read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


def split_workspace(device: torch.device, m: int, n: int,
                    tile: tuple[int, int] = (GEMM_TILE, GEMM_TILE), stream: int | None = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ws, arrivals)`` for a split-K launch with an M×N output on
    ``device``'s current stream (``stream_conv_grad_w_opt``, the forward
    matmuls, ``nitro_matmul_grad_x``): int32 split sums (≥ M·N) and one
    arrival counter per ``tile`` of the output (the launching kernel's own
    tile), both zero.

    Each launch leaves them zero again, so one pair per (device, stream)
    serves every call in stream order, whichever kernel makes it; it
    grows to the largest output and tile count seen (9.4 MB at VGG8B's
    conv 6) and is zeroed once, when allocated.  ``stream``: the current
    stream's handle, where the caller has it already.
    """
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream)
    with _lock:
        ws, arrivals = _workspaces.get(key, (None, None))
        if ws is None or ws.numel() < m * n:
            ws = torch.zeros(max(m * n, 1), dtype=torch.int32, device=device)
        if arrivals is None or arrivals.numel() < tiles:
            arrivals = torch.zeros(max(tiles, 1), dtype=torch.int32, device=device)
        _workspaces[key] = (ws, arrivals)
    return ws, arrivals


def sgd_scalar(name: str, v, device: torch.device) -> torch.Tensor:
    """An IntegerSGD divisor as the 0-d int32 tensor on ``device`` that the
    kernels read (γ_inv / η_inv of the optimiser state are such tensors
    already; a Python int is copied over)."""
    if not isinstance(v, torch.Tensor):
        return torch.tensor(int(v), dtype=torch.int32, device=device)
    if v.numel() != 1 or v.dtype != torch.int32 or v.device != device:
        raise ValueError(
            f"{name} must be an int32 scalar on {device}, got "
            f"{v.dtype}{tuple(v.shape)} on {v.device}")
    return v.reshape(()).contiguous()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name} kernel needs its operands on one CUDA device, got "
            f"{[str(t.device) for t in tensors]} (CPU tensors go to the "
            f"plain version)"
        )


def as_int32(name: str, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Lift integer operands to contiguous int32 (the training dtype); an
    int32 operand is not passed through ``to``, whose call alone costs the
    host about 2 µs."""
    out = []
    for t in tensors:
        if t.dtype not in (torch.int8, torch.int16, torch.int32):
            raise ValueError(f"{name}: integer operands expected, got {t.dtype}")
        out.append((t if t.dtype == torch.int32 else t.to(torch.int32)).contiguous())
    return out


def check_inputs(name: str, x: torch.Tensor, w: torch.Tensor, *,
                 operand_dtype: str, out_dtype: torch.dtype, apply_relu: bool,
                 alpha_inv: int, lift: bool = True,
                 ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Shared wrapper checks: one CUDA device, integer operands, output dtype.

    Returns the operands as the kernel takes them — int8 as they are for
    ``operand_dtype='int8'``, lifted to int32 for ``'int32'`` (left as they
    are with ``lift=False``, for a kernel that reads each dtype itself) —
    and the α_inv to pass (1 when the ReLU is off and α_inv is unused).
    """
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"{name} kernel needs x and w on one CUDA device, got "
            f"{x.device}/{w.device} (CPU tensors go to the plain version)"
        )
    if out_dtype not in (torch.int8, torch.int32):
        raise ValueError(f"out_dtype must be int8 or int32, got {out_dtype}")
    if operand_dtype == "int8":
        if not (x.dtype == torch.int8 and w.dtype == torch.int8):
            raise ValueError(
                f"operand_dtype='int8' requires int8 operands, got "
                f"{x.dtype}/{w.dtype} (the dispatcher narrows eligible inputs)"
            )
    elif operand_dtype == "int32":
        for t in (x, w):
            if t.dtype not in (torch.int8, torch.int16, torch.int32):
                raise ValueError(f"integer operands expected, got {t.dtype}")
        if lift:
            x, w = x.to(torch.int32), w.to(torch.int32)
    else:
        raise ValueError(
            f"operand_dtype must be 'int8' or 'int32', got {operand_dtype!r}")
    if not apply_relu:
        alpha_inv = 1  # unused without the ReLU
    elif alpha_inv < 1:
        raise ValueError(f"alpha_inv must be >= 1, got {alpha_inv}")
    return x.contiguous(), w.contiguous(), alpha_inv
