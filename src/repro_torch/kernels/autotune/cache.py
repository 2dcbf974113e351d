"""On-disk JSON cache of tuned tile configurations (port of
``repro.kernels.autotune.cache``).

One cache file holds every tuned entry for one build fingerprint::

    {
      "fingerprint": "repro_torch=0.8.0|torch=2.x|…|device=cpu",
      "entries": {
        "conv_fwd|4x32x32x3x3x8|int32,int32|reference|stream|0|0": {"bh": 4, …},
        ...
      }
    }

* **Keyed** by ``(op, shape, dtype, backend, conv_mode, fuse_bwd,
  fuse_opt)``, the JAX package's key strings letter for letter (dtypes as
  ``int32`` / ``int8``, never ``torch.int32``).  A tile choice never
  changes a result, only speed, so a stale entry costs speed at worst;
  the **fingerprint** still invalidates the whole file when the port's
  version, torch, CUDA, the card or nvcc changes, because a timing taken
  on another build or card says nothing of this one.
* **Corruption-safe**: an unreadable, wrong-shape or other-fingerprint
  file loads as an empty cache (re-tune, never crash).
* **Concurrent writers**: a write holds an exclusive ``flock`` on the
  sidecar ``<path>.lock`` (the cache file itself is replaced, so its fd
  cannot carry the lock) while it re-reads the file, merges, writes a
  temp file in the same directory and ``os.replace``\\ s it: readers never
  see a torn file, and writers (threads or processes) lose no entry.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import tempfile
import threading

try:
    import fcntl
except ImportError:  # non-POSIX: atomic-replace-only writes
    fcntl = None

import torch

from .tiles import TileConfig

CACHE_FILENAME = "tile_cache.json"


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    """nvcc's release (``12.4``), read once; ``none`` without the toolkit."""
    from repro_torch.kernels import cuda_lib

    try:
        out = subprocess.run([cuda_lib.nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"
    m = re.search(r"release (\S+?),", out)
    return m.group(1) if m else "unknown"


def build_fingerprint(device=None) -> str:
    """Identity of the code, compiler and card the cached timings were
    taken on.  ``device`` defaults to the card when there is one."""
    from repro_torch.obs.metrics import REPRO_VERSION

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    head = f"repro_torch={REPRO_VERSION}|torch={torch.__version__}"
    if dev.type != "cuda":
        return f"{head}|device=cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    return (f"{head}|cuda={torch.version.cuda}"
            f"|device={torch.cuda.get_device_name(index)}"
            f"|capability={major}.{minor}|nvcc={_nvcc_version()}")


def dtype_name(dtype) -> str:
    """``torch.int32`` → ``int32`` (a string passes through)."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


def cache_key(op: str, shape, dtype, backend: str, conv_mode: str = "",
              fuse_bwd: bool = False, fuse_opt: bool = False) -> str:
    """The canonical string key for one tuning problem; ``dtype`` is the
    JAX package's ``"x,w"`` string or a pair of torch dtypes."""
    if not isinstance(dtype, str):
        dtype = ",".join(dtype_name(d) for d in dtype)
    dims = "x".join(str(int(d)) for d in shape)
    return (f"{op}|{dims}|{dtype}|{backend}|{conv_mode or '-'}"
            f"|{int(fuse_bwd)}|{int(fuse_opt)}")


class TileCache:
    """A path-backed mapping from cache keys to ``TileConfig``."""

    def __init__(self, path, *, fingerprint: str | None = None, device=None):
        path = os.fspath(path)
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, CACHE_FILENAME)
        self.path = path
        self.fingerprint = fingerprint or build_fingerprint(device)
        self._lock = threading.Lock()
        self._entries: dict[str, TileConfig] = self._load()

    def _load(self) -> dict[str, TileConfig]:
        """Parse the file; anything unusable is an empty cache."""
        try:
            with open(self.path) as f:
                payload = json.load(f)
            if payload.get("fingerprint") != self.fingerprint:
                return {}  # another build or card: its timings do not apply
            return {str(k): TileConfig.from_json(v)
                    for k, v in payload["entries"].items()}
        except (OSError, ValueError, KeyError, AttributeError, TypeError):
            return {}

    @contextlib.contextmanager
    def _file_lock(self):
        """Exclusive inter-process lock for a read-merge-write cycle."""
        if fcntl is None:
            yield
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # closing releases the flock

    def _write(self) -> None:
        """Merge with the file, then publish atomically; the caller holds
        ``self._lock`` and ``_file_lock``."""
        on_disk = self._load()
        on_disk.update(self._entries)
        self._entries = on_disk
        payload = {
            "fingerprint": self.fingerprint,
            "entries": {k: v.to_json() for k, v in sorted(self._entries.items())},
        }
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tile_cache.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            finally:
                raise

    def get(self, key: str) -> TileConfig | None:
        with self._lock:
            return self._entries.get(key)

    def put(self, key: str, tiles: TileConfig) -> None:
        with self._lock, self._file_lock():
            self._entries[key] = tiles
            self._write()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)
