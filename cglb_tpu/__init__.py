"""cglb_tpu: CGLB — scalable GP regression with conjugate-gradient lower bounds
(Artemev, Burt & van der Wilk, ICML 2021), built from scratch on JAX/XLA/Pallas.

Single-backend re-design of awav/CGLB: one functional JAX stack replaces the
reference's parallel GPflow/TF and GPytorch/KeOps backends, with Pallas streaming
kernel matvecs instead of KeOps and jax.sharding instead of MultiDeviceKernel.
"""

from . import config
from .config import (
    set_default_float,
    set_default_jitter,
    set_default_seed,
    default_float,
    default_jitter,
)
from .transforms import Param, positive
from .ops import kernels
from .ops.kernels import SquaredExponential, Matern32, make_kernel
from .models import gpr, sgpr, cglb
from .models.sgpr import SGPRParams
from .models.gpr import GPRParams
from .models.cglb import CGLBConfig

__version__ = "0.1.0"

__all__ = [
    "config",
    "set_default_float",
    "set_default_jitter",
    "set_default_seed",
    "default_float",
    "default_jitter",
    "Param",
    "positive",
    "kernels",
    "SquaredExponential",
    "Matern32",
    "make_kernel",
    "gpr",
    "sgpr",
    "cglb",
    "SGPRParams",
    "GPRParams",
    "CGLBConfig",
]
