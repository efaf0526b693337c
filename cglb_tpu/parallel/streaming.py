"""Sharded streaming kernel matvec: Pallas kernel + shard_map over the mesh.

The large-N story (SURVEY.md sections 5.7-5.8): the reference streams K@v on
one GPU via KeOps and has no multi-device matvec.  Here the column space of
K(X, X) is sharded over the mesh's data axis; each device runs the streaming
kernel on its column block against the full row space:

    out[:, cols_d] = p @ K(X_all, X_cols_d)      (per device, K never stored)

then the result is reassembled by shard_map's output spec (an all-gather that
XLA issues as a collective).  Memory per device: the prepared coordinates of
X (D * 4 bytes per point) + CG vectors, with the O(N^2) compute split across
the mesh.

The coordinates are prepared ONCE per operator construction (outside the CG
while_loop); the per-device column slice is what shard_map hands each
device.  The kernel's route follows the platform each shard is lowered for
(ops/matvec_pallas).  Gradients: the custom_vjp inside shard_map yields
per-device partial var/ls cotangents that shard_map's reverse psums
automatically.
"""

from __future__ import annotations

import functools
from typing import Callable

from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import matvec_pallas as _mv
from .mesh import DATA_AXIS

__all__ = ["make_sharded_streaming_operator"]


def make_sharded_streaming_operator(mesh: Mesh, kernel, X, sigma_sq,
                                    block_i: int = _mv.BLOCK_I,
                                    block_j: int = _mv.BLOCK_J) -> Callable:
    """Matvec closure p [B, N] -> p (K + s2 I) [B, N], column-sharded.

    Arbitrary N: the prepared coordinates are zero-padded up to a multiple
    of mesh_size * max(block_i, block_j), so each device's column slice is
    whole blocks in either role (padded points are harmless — p
    is zero there and the padded output columns are sliced off, exactly as
    in the single-device kernel).
    """
    spec = _mv._spec_for(kernel, block_i, block_j)
    n_dev = mesh.shape[DATA_AXIS]
    n = X.shape[0]
    var = kernel.variance.value
    ls = kernel.lengthscales.value
    prep = _mv._prepare(X, ls, spec.family, n_dev * max(block_i, block_j))
    n_pad = prep.shape[1]
    cols_per_dev = n_pad // n_dev

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(None, DATA_AXIS), P(), P()),
        out_specs=P(None, DATA_AXIS),
        # pallas_call outputs carry no varying-mesh-axis metadata
        check_vma=False,
    )
    def _sharded(p, rows, cols, var_, ls_):
        return _mv._streaming_matvec(
            spec, cols_per_dev, rows, cols, var_, ls_, p
        )

    def matvec(p):
        pf = _mv._pad_cols(p, n_pad)
        out = _sharded(pf, prep, prep, var, ls)
        return out[:, :n].astype(p.dtype) + sigma_sq * p

    return matvec
