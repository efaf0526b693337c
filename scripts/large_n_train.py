"""Single-card CGLB training at houseelectric scale (SURVEY.md 5.7).

Runs REAL optimizer steps (loss + grad + Adam update) on N>=1M synthetic
rows with the streaming Pallas matvec and mixed gram-form common terms —
the proof that the training graph, not just the standalone matvec,
compiles and executes at large N on one card.  Records compile wall,
warm per-feval wall, Adam step time, and device memory stats.

Reference role: the large-N axis the reference serves through KeOps
streaming + MultiDeviceKernel row sharding
(cglb/backend/pytorch/models.py:251-252, interface.py:241-244).

Run:  JAX_ENABLE_X64=true python scripts/large_n_train.py --n 1048576
Prints one JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))


def log(m):
    print(f"# {time.strftime('%H:%M:%S')} {m}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--max-cg-iters", type=int, default=16,
                    help="CG cap: at N~1M each CG iteration is a multi-"
                         "second streaming matvec; 16 covers the warm-start "
                         "training regime (a handful of steps per feval)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    from cglb_tpu.backend import Model
    from cglb_tpu.models import sgpr as sgpr_mod
    from cglb_tpu.models.cglb import CGLBConfig
    from cglb_tpu.ops import kernels as k
    from cglb_tpu.utils import training

    N, D, M = args.n, args.d, args.m
    rng = np.random.default_rng(0)
    kern = k.make_kernel("Matern32", D, variance=1.0, lengthscales=1.0,
                         dtype=np.float64)
    Z = rng.normal(size=(M, D))
    params = sgpr_mod.SGPRParams.create(kern, Z, noise_variance=0.5,
                                        dtype=np.float64)
    rec = {"n": N, "d": D, "m": M,
           "device": str(jax.devices()[0]).strip()}

    @jax.jit
    def make_data(key):
        kx, kn = jax.random.split(key)
        X = jax.random.normal(kx, (N, D), dtype=jnp.float64)
        w = jnp.linspace(0.5, 1.5, D, dtype=jnp.float64)
        Y = jnp.sin(X @ w[:, None]) + 0.3 * jax.random.normal(
            kn, (N, 1), dtype=jnp.float64)
        return X, Y

    X, Y = make_data(jax.random.PRNGKey(0))
    jax.block_until_ready(X)
    log("data ready")

    def memstats(tag):
        st = jax.devices()[0].memory_stats() or {}
        ib, pk = st.get("bytes_in_use", 0), st.get("peak_bytes_in_use", 0)
        log(f"{tag}: in_use {ib/2**30:.2f} GiB, peak {pk/2**30:.2f} GiB")
        return pk / 2**30

    memstats("after data")
    model = Model("cglb", params, (X, Y),
                  run_cfg=CGLBConfig(max_cg_iters=args.max_cg_iters),
                  matvec="streaming", common_dtype="mixed")
    loss_fn = model.loss_fn()
    carry = model._carry_in()

    def wrapped(p, c, X, Y):
        (l, aux), g = jax.value_and_grad(
            lambda q: loss_fn(q, c, X, Y), has_aux=True)(p)
        # consume every gradient leaf or XLA dead-code-eliminates the
        # backward
        s = sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(g))
        return l + 1e-30 * s, aux

    vg = jax.jit(wrapped)
    log("compiling loss+grad (cold)")
    t0 = time.time()
    l, aux = vg(model.params, carry, X, Y)
    lf = float(l)
    rec["cold_s"] = round(time.time() - t0, 1)
    log(f"cold first call (compile+run): {rec['cold_s']} s loss={lf:.2f}")
    rec["peak_after_first_gib"] = round(memstats("after first feval"), 2)

    t0 = time.time()
    l, aux = vg(model.params, aux, X, Y)
    float(l)
    log(f"second call (carry recompile): {time.time()-t0:.1f} s")

    times = []
    for _ in range(3):
        t0 = time.time()
        l, aux = vg(model.params, aux, X, Y)
        float(l)
        times.append(time.time() - t0)
    rec["warm_feval_s"] = round(min(times), 2)
    rec["cg_steps"] = int(aux.cg_steps)
    log(f"warm feval: {min(times):.2f} s min / {np.mean(times):.2f} s mean "
        f"(cg_steps={int(aux.cg_steps)}) loss={float(l):.2f}")
    rec["peak_gib"] = round(memstats("steady state"), 2)

    log(f"{args.steps} adam steps via training.adam_minimize")
    t0 = time.time()
    res = training.adam_minimize(model.loss_fn(), model.params,
                                 model._carry_in(), num_steps=args.steps,
                                 lr=0.01, data=(X, Y))
    rec["adam_steps"] = args.steps
    rec["adam_total_s"] = round(time.time() - t0, 1)
    rec["final_loss"] = float(res.final_loss)
    rec["loss_finite"] = bool(np.isfinite(res.final_loss))
    log(f"{args.steps} adam steps: {rec['adam_total_s']} s total, "
        f"final loss {res.final_loss:.2f}")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
