"""Device-mesh helpers.

The reference's only multi-device mechanism is gpytorch's MultiDeviceKernel —
row-block data parallelism for kernel evaluation across CUDA GPUs
(cglb/backend/pytorch/interface.py:241-244).  The equivalent here is a 1-D
``jax.sharding.Mesh`` over the data axis: kernel-matrix columns, CG state,
and Kuf columns are sharded along N; M x M terms stay replicated; XLA inserts
the psum/all-gather collectives (NCCL between GPUs).  A 1-D mesh fits cards
joined all to all, where every pair talks at the same rate.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["data_mesh", "P", "NamedSharding", "replicated", "data_sharded",
           "maybe_initialize_distributed"]

DATA_AXIS = "data"

_DIST_INITIALIZED = False


def maybe_initialize_distributed() -> bool:
    """Multi-host entry point: call ``jax.distributed.initialize`` when the
    environment asks for it, so ``jax.devices()`` (and therefore data_mesh /
    --mesh all) spans every host.

    Activation (first match wins; returns True when initialization ran):

    - ``CGLB_DIST=auto`` — ``jax.distributed.initialize()`` with no
      arguments, for clusters whose scheduler JAX can read the coordinator
      and process topology from.
    - ``CGLB_COORDINATOR`` (+ ``CGLB_NUM_PROCESSES``, ``CGLB_PROCESS_ID``) —
      explicit addressing (``localhost:<port>`` for one machine), used for
      multi-process CPU/GPU launches and the 2-process CPU dry-run test
      (tests/test_distributed.py).
    - otherwise: no-op (single-process; the default everywhere else).

    Idempotent: repeated calls (CLI + library both call it) initialize once.
    SURVEY.md section 5.8: the collectives come from jit/GSPMD over the
    mesh; this hook is the multi-host bootstrap.
    """
    global _DIST_INITIALIZED
    if _DIST_INITIALIZED:
        return True
    mode = os.environ.get("CGLB_DIST", "").lower()
    coord = os.environ.get("CGLB_COORDINATOR")
    if mode == "auto":
        jax.distributed.initialize()
    elif coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["CGLB_NUM_PROCESSES"]),
            process_id=int(os.environ["CGLB_PROCESS_ID"]),
        )
    else:
        return False
    _DIST_INITIALIZED = True
    return True


def data_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the data axis using the first n GLOBAL devices (all
    hosts' devices once maybe_initialize_distributed has run)."""
    if devices is None:
        maybe_initialize_distributed()
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, axis_index: int = 0, ndim: int = 2) -> NamedSharding:
    """Sharding with the data axis on dimension `axis_index` of an ndim array."""
    spec = [None] * ndim
    spec[axis_index] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))
