"""Compute placement and host-process tuning.

Placement rule: every tool runs its host-native engine when JAX's
backend is the CPU, and its device path otherwise. The same answer
serves every pipeline, so it lives here and nowhere else.
"""

from __future__ import annotations

import os

from genometester4_tpu.utils.lazyjax import jax


def prefer_host() -> bool:
    """True when the tools should run their host-native engines.

    ``JAX_PLATFORMS=cpu`` answers without importing jax, so host-path
    CLI runs under the bin/ launchers never pay the jax import."""
    if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return True
    return jax.default_backend() == "cpu"


_thp_disabled = False


def disable_numpy_thp():
    """Turn off numpy's MADV_HUGEPAGE on large allocations.

    On virtualized hosts the transparent-huge-page madvise makes the
    first touch of a multi-hundred-MB buffer several times slower
    (zeroing and compaction), and the host counting pipelines allocate
    such buffers on every run. Safe to call any time; idempotent."""
    global _thp_disabled
    if _thp_disabled:
        return
    try:
        try:
            from numpy._core import multiarray as _ma
        except ImportError:                      # numpy < 2
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:
        pass
    _thp_disabled = True
