"""Warm loss+grad feval timing of the CGLB objective at kin40k shape
(N=40960, D=8, M=2048, mixed, streaming matvec), plus the cold first call
(compile + run).  Operands are generated on the device.

    python scripts/bench_feval.py [--M 4096] [--json]
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cglb_tpu.backend import Model  # noqa: E402
from cglb_tpu.models import sgpr as sgpr_mod  # noqa: E402
from cglb_tpu.models.cglb import CGLBConfig  # noqa: E402
from cglb_tpu.ops import kernels as k  # noqa: E402


def measure_feval(N: int = 40960, D: int = 8, M: int = 2048,
                  repeats: int = 5, log=print) -> dict:
    """{'warm_feval_s', 'cold_compile_s', 'cg_steps'} for one loss+grad."""
    rng = np.random.default_rng(0)
    kern = k.make_kernel("Matern32", D, variance=1.0, lengthscales=1.0,
                         dtype=np.float64)
    params = sgpr_mod.SGPRParams.create(kern, rng.normal(size=(M, D)),
                                        noise_variance=0.5, dtype=np.float64)

    @jax.jit
    def make_data(key):
        kx, kn = jax.random.split(key)
        X = jax.random.normal(kx, (N, D), dtype=jnp.float64)
        w = jnp.linspace(0.5, 1.5, D, dtype=jnp.float64)
        Y = jnp.sin(X @ w[:, None]) + 0.5 * jax.random.normal(
            kn, (N, 1), dtype=jnp.float64)
        return X, Y

    X, Y = make_data(jax.random.PRNGKey(0))
    model = Model("cglb", params, (X, Y), run_cfg=CGLBConfig(),
                  matvec="streaming", common_dtype="mixed")
    loss_fn = model.loss_fn()

    def wrapped(p, c, X, Y):
        (l, aux), g = jax.value_and_grad(
            lambda q: loss_fn(q, c, X, Y), has_aux=True)(p)
        # consume every grad leaf so XLA cannot DCE the backward
        s = sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(g))
        return l + 1e-30 * s, aux

    vg = jax.jit(wrapped)
    t0 = time.perf_counter()
    l, aux = jax.block_until_ready(vg(model.params, model._carry_in(), X, Y))
    t_cold = time.perf_counter() - t0
    log(f"cold first call (compile+run): {t_cold:.1f} s  loss={float(l):.2f}")
    # the carry is now a CGLBAux, not the raw v0 array: a new input
    # structure, so compile that variant too before timing
    l, aux = jax.block_until_ready(vg(model.params, aux, X, Y))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        l, aux = jax.block_until_ready(vg(model.params, aux, X, Y))
        times.append(time.perf_counter() - t0)
    log(f"warm feval: {min(times):.4f} s min / {np.mean(times):.4f} s mean "
        f"(cg_steps={int(aux.cg_steps)})  loss={float(l):.2f}")
    return {"warm_feval_s": min(times), "cold_compile_s": t_cold,
            "cg_steps": int(aux.cg_steps)}


if __name__ == "__main__":
    M = int(sys.argv[sys.argv.index("--M") + 1]) if "--M" in sys.argv else 2048
    result = measure_feval(M=M)
    if "--json" in sys.argv:
        print(json.dumps(result), flush=True)
