"""Experiment-level config dataclasses + string registries.

Mirrors the reference's config system (cglb/backend/config.py:45-166): frozen
dataclasses describing kernels / models / inducing variables, with string
registries used by the CLI to map names to config classes.  ``params(data)``
returns construction-time defaults exactly as the reference does (variance=1,
ARD lengthscales=1, noise=1; config.py:73-89).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Tuple, Union

import numpy as np

__all__ = [
    "Config",
    "ModelConfig",
    "KernelConfig",
    "SquaredExponentialConfig",
    "Matern32Config",
    "InducingVariableConfig",
    "GPRConfig",
    "SGPRConfig",
    "CGLBConfig",
    "CGLBN2MConfig",
    "CGLBNM2Config",
    "SGPRN2MConfig",
    "GPR_CONFIGS",
    "SGPR_CONFIGS",
    "KERNEL_CONFIGS",
    "INDUCING_VARIABLE_CONFIGS",
]

Data = Tuple[np.ndarray, np.ndarray]
_frozen = partial(dataclasses.dataclass, frozen=True)


class Config:
    def params(self, data: Data) -> Dict[str, Union[float, np.ndarray]]:
        return {}


@_frozen
class ModelConfig(Config):
    pass


class KernelConfig(Config):
    pass


@_frozen
class SquaredExponentialConfig(KernelConfig):
    def params(self, data: Data) -> Dict[str, Union[float, np.ndarray]]:
        vecdim = data[0].shape[-1]
        return {"variance": 1.0, "lengthscales": np.repeat(1.0, vecdim)}


@_frozen
class Matern32Config(SquaredExponentialConfig):
    pass


@_frozen
class InducingVariableConfig(Config):
    """Greedy ConditionalVariance selection of M inducing points
    (reference: config.py:56-65 via robustgp)."""

    num_variables: int

    def init(self, data: Data, kernel, seed: int = 0) -> np.ndarray:
        # prefer the OpenMP C++ implementation: the selection is sequential in
        # M, so per-step device dispatch dominates the jitted device version
        # (~minutes at M=1024) while the native one finishes in seconds
        try:
            from .utils.native import conditional_variance_native, \
                native_available

            if native_available():
                Z, _ = conditional_variance_native(
                    data[0], self.num_variables, kernel, seed=seed
                )
                return Z
        except Exception:
            pass
        from .utils.inducing import conditional_variance

        Z, _ = conditional_variance(data[0], self.num_variables, kernel, seed=seed)
        return Z


@_frozen
class GPRConfig(ModelConfig):
    kernel: KernelConfig

    def params(self, data: Data) -> Dict[str, Union[float, np.ndarray]]:
        return {"noise_variance": 1.0}


@_frozen
class ExactGPConfig(GPRConfig):
    pass


@_frozen
class SGPRConfig(ModelConfig):
    kernel: KernelConfig
    inducing_variable: InducingVariableConfig

    def params(self, data: Data) -> Dict[str, Union[float, np.ndarray, Callable]]:
        return {
            "noise_variance": 1.0,
            "inducing_variable": partial(self.inducing_variable.init, data),
        }


@_frozen
class CGLBConfig(SGPRConfig):
    max_error: float = 1.0
    joint_optimization: bool = False
    vzero: bool = False

    def params(self, data: Data):
        d = super().params(data)
        d.update(
            max_error=self.max_error,
            joint_optimization=self.joint_optimization,
            vzero=self.vzero,
        )
        return d


@_frozen
class CGLBN2MConfig(CGLBConfig):
    pass


@_frozen
class CGLBNM2Config(CGLBConfig):
    pass


@_frozen
class SGPRN2MConfig(SGPRConfig):
    pass


GPR_CONFIGS = {"gpr": GPRConfig, "exactgp": ExactGPConfig}

SGPR_CONFIGS = {
    "sgpr": SGPRConfig,
    "cglb": CGLBConfig,
    "sgprn2m": SGPRN2MConfig,
    "cglbn2m": CGLBN2MConfig,
    "cglbnm2": CGLBNM2Config,
}

KERNEL_CONFIGS = {
    "SquaredExponential": SquaredExponentialConfig,
    "Matern32": Matern32Config,
    "mat32": Matern32Config,
    "rbf": SquaredExponentialConfig,
}

INDUCING_VARIABLE_CONFIGS = {
    "InducingVariable": InducingVariableConfig,
    "ConditionalVariance": InducingVariableConfig,
    "iv": InducingVariableConfig,
    "cv": InducingVariableConfig,
}
