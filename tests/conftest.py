"""Test-suite bootstrap.

Two jobs:

  1. make the property tests collect everywhere: when the real
     ``hypothesis`` package is unavailable (this container has no network
     access to install it) the deterministic fallback in
     ``tests/_compat/hypothesis`` is put on ``sys.path`` — same decorator
     API, boundary-biased pseudo-random example generation, no shrinking;
  2. register the ``slow`` marker so long-running integration tests (the
     serving engine end-to-end) can be excluded from quick CI runs with
     ``-m "not slow"`` (see tools/ci_check.sh) while still running under
     the full tier-1 command.
"""

from __future__ import annotations

import importlib.util
import os
import sys

if importlib.util.find_spec("hypothesis") is None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_compat"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running integration test; excluded by tools/ci_check.sh "
        "quick runs via -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's kernels); skips without one",
    )
