"""Global numeric configuration.

The reference library configures float type / jitter / seed once per process on a
backend object (reference: cglb/backend/backend.py:72-91, cglb/backend/tensorflow/
interface.py:87-119).  We keep the same once-per-process model: a tiny module-level
settings object consulted when *creating* models.  All jitted compute is purely
functional; the settings only pick dtypes and constants at construction time.

Importing this module also sets two process-wide JAX options that every entry
point (library, CLI, scripts, chip_smoke.py) passes through:

- fp64 (``jax_enable_x64``) unless JAX_ENABLE_X64 opts out;
- ``jax_default_matmul_precision = "highest"``: on the GPU an f32 matmul at the
  default precision runs in TF32 (~1e-3 relative).  The f32 products on the
  training path — the Nystrom preconditioner's A A^T and applies
  (models/cglb._make_precond, ops/preconditioners), the f32 A build
  (models/sgpr._gram_terms), the preconditioner Cholesky's backward
  (ops/chol64), the distance expansion in ``-t fp32`` runs (ops/kernels) and
  every model product in ``-t fp32`` runs — need true f32.  Most of them also
  pass ``precision=HIGHEST`` explicitly; this setting covers the rest.  fp64
  products are unaffected.  The streaming matvec kernel has no dot at all.

and keeps XLA's persistent compilation cache in ``JAX_COMPILATION_CACHE_DIR``
when that is set, otherwise in ``.jax_cache/`` at the root of the checkout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import numpy as np

__all__ = [
    "default_float",
    "default_jitter",
    "positive_lower_bound",
    "set_default_float",
    "set_default_jitter",
    "set_default_seed",
    "settings",
]

_FLOAT_ALIASES = {
    "fp32": np.float32,
    "float32": np.float32,
    "fp64": np.float64,
    "float64": np.float64,
    np.float32: np.float32,
    np.float64: np.float64,
    np.dtype(np.float32): np.float32,
    np.dtype(np.float64): np.float64,
}

# Reference jitter policy: 1e-5 for fp32, 1e-6 for fp64
# (reference: cglb/backend/backend.py:76-83).
_DEFAULT_JITTER = {np.float32: 1e-5, np.float64: 1e-6}

# Reference lower bound for positive parameters: 5e-3 (fp32) / 1e-6 (fp64)
# (reference: cglb/backend/tensorflow/interface.py:167-171).
_POSITIVE_LOWER = {np.float32: 5e-3, np.float64: 1e-6}


@dataclasses.dataclass
class _Settings:
    float_type: type = np.float64
    jitter: Optional[float] = None  # None -> dtype-dependent default
    seed: int = 0

    @property
    def effective_jitter(self) -> float:
        if self.jitter is not None:
            return self.jitter
        return _DEFAULT_JITTER[self.float_type]


settings = _Settings()


def default_float() -> type:
    return settings.float_type


def default_jitter() -> float:
    return settings.effective_jitter


def positive_lower_bound(dtype=None) -> float:
    ft = _FLOAT_ALIASES[dtype] if dtype is not None else settings.float_type
    return _POSITIVE_LOWER[ft]


def set_default_float(float_type) -> None:
    """Set the process-wide default float ("fp32"/"fp64" or numpy dtype)."""
    if float_type not in _FLOAT_ALIASES:
        raise NotImplementedError(f"Unknown float type {float_type!r}")
    settings.float_type = _FLOAT_ALIASES[float_type]
    if settings.float_type is np.float64:
        jax.config.update("jax_enable_x64", True)


def set_default_jitter(value) -> None:
    """Set jitter; accepts a float or a float-type string for the dtype default."""
    if isinstance(value, str):
        ft = _FLOAT_ALIASES[value]
        settings.jitter = _DEFAULT_JITTER[ft]
    else:
        settings.jitter = float(value)


def set_default_seed(seed: int) -> None:
    settings.seed = int(seed)
    np.random.seed(seed)


def enable_x64() -> None:
    jax.config.update("jax_enable_x64", True)


# fp64 is the reference's experiment dtype; enable by default unless the user
# explicitly opted out through JAX's own env var.
if os.environ.get("JAX_ENABLE_X64", "").lower() not in ("0", "false"):
    enable_x64()


jax.config.update("jax_default_matmul_precision", "highest")


# Honor JAX_PLATFORMS explicitly: a plugin imported before this module can
# freeze the platform list from the original environment — the config update
# is authoritative as long as no backend has been touched yet (same technique
# as tests/conftest.py; lets CLI entry points run forced CPU meshes, e.g.
# `JAX_PLATFORMS=cpu ... --mesh 8` with
# --xla_force_host_platform_device_count).
_platforms_env = os.environ.get("JAX_PLATFORMS", "")
if _platforms_env:
    try:
        jax.config.update("jax_platforms", _platforms_env)
    except Exception:  # backend already initialized by the embedding process
        pass


# the checkout's own cache directory (listed in .gitignore): a fixed path, so
# later processes in the same checkout find what earlier ones compiled
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set (JAX reads it itself), else the
    checkout's ``.jax_cache/``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE_DIR


# fp64-heavy CGLB graphs take long to compile; the persistent cache makes
# that a one-time cost per (shape, config).  JAX reads the env var itself.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", _REPO_CACHE_DIR)
