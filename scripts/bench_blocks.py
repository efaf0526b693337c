"""Per-block feval budget at the kin40k shape (N=40960, M=2048, mixed).

Times each stage of the CGLB loss+grad standalone on the GPU so the feval
cost is attributed to measured blocks instead of estimates:

  ct_fwd    common_terms (df32 Kuf + gram matmuls + AAT sandwich + chols)
  ct_vjp    common_terms forward + full-cotangent backward
  qf_warm   _quad_form_bound at a converged warm start (cg_steps ~ 0)
  qf_cold   _quad_form_bound from v0 = 0 (the in-training CG cost ceiling)
  loss_fwd  full loss forward
  loss_vg   full loss + grad (same graph bench_feval.py times)

Operands are generated on the device.  Each block: 1 warmup + min over 5
timed runs.
"""
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from cglb_tpu.backend import Model
from cglb_tpu.models import cglb as cglb_mod
from cglb_tpu.models import sgpr as sgpr_mod
from cglb_tpu.models.cglb import CGLBConfig
from cglb_tpu.ops import kernels as k
from cglb_tpu.ops import matvec_pallas as _mvp


def log(m):
    print(f"# {time.strftime('%H:%M:%S')} {m}", flush=True)


import os

# shape overrides for off-north-star points (e.g. BB_M=4096 for the
# protocol's largest sweep point)
N = int(os.environ.get("BB_N", 40960))
D = int(os.environ.get("BB_D", 8))
M = int(os.environ.get("BB_M", 2048))
rng = np.random.default_rng(0)
kern = k.make_kernel("Matern32", D, variance=1.0, lengthscales=1.0,
                     dtype=np.float64)
Z = rng.normal(size=(M, D))
params = sgpr_mod.SGPRParams.create(kern, Z, noise_variance=0.5,
                                    dtype=np.float64)
log("making data on device")


@jax.jit
def make_data(key):
    kx, kn = jax.random.split(key)
    X = jax.random.normal(kx, (N, D), dtype=jnp.float64)
    w = jnp.linspace(0.5, 1.5, D, dtype=jnp.float64)
    Y = jnp.sin(X @ w[:, None]) + 0.5 * jax.random.normal(
        kn, (N, 1), dtype=jnp.float64)
    return X, Y


X, Y = make_data(jax.random.PRNGKey(0))
X.block_until_ready()
log("data ready")

cfg = CGLBConfig()
model = Model("cglb", params, (X, Y), run_cfg=cfg, matvec="streaming",
              common_dtype="mixed")
loss_fn = model.loss_fn()
carry0 = model._carry_in()


def bench(tag, fn, *args, reps=5):
    t0 = time.time()
    out = fn(*args)
    fetch = jax.block_until_ready
    fetch(out)
    log(f"{tag}: first call {time.time() - t0:.1f} s (compile or cache hit)")
    times = []
    for _ in range(reps):
        t0 = time.time()
        out = fn(*args)
        fetch(out)
        times.append(time.time() - t0)
    log(f"{tag}: min {min(times)*1e3:.1f} ms / mean {np.mean(times)*1e3:.1f} ms")
    return out


which = sys.argv[1:] or ["ct", "ctvjp", "qf", "loss", "lossg"]

# the exact common_terms call bound() makes at these settings (mixed gram
# path, remat off below REMAT_THRESHOLD_ELEMENTS)
ct_kwargs = dict(mixed=True, gram=True, a_dtype=jnp.dtype(cfg.precond_dtype),
                 remat=False)

ct_fn = jax.jit(lambda p, X: sgpr_mod.common_terms(p, X, **ct_kwargs))
ct = None
if "ct" in which or "qf" in which:
    ct = bench("ct_fwd", ct_fn, model.params, X)

if "ctvjp" in which:
    def ct_vjp(p, X):
        out, pull = jax.vjp(lambda q: sgpr_mod.common_terms(q, X, **ct_kwargs), p)
        cot = jax.tree_util.tree_map(jnp.ones_like, out)
        (gp,) = pull(cot)
        return out.LB, gp
    bench("ct_vjp", jax.jit(ct_vjp), model.params, X)

if "qf" in which:
    def qf(p, ct, v0, X, Y):
        # same wiring as the backend's training loss
        mv = _mvp.make_streaming_operator(p.kernel, X, p.noise_variance.value)
        return cglb_mod._quad_form_bound(p, ct, X, Y, v0, cfg, mv,
                                         consistent_ct=False)

    qf_j = jax.jit(qf)
    v0 = cglb_mod.init_v0(N)
    _, aux_cold = bench("qf_cold (v0=0, full CG)", qf_j, model.params, ct, v0, X, Y)
    log(f"  qf_cold cg_steps={int(aux_cold.cg_steps)}")
    vwarm = aux_cold.v
    _, aux_warm = bench("qf_warm (converged v)", qf_j, model.params, ct, vwarm, X, Y)
    log(f"  qf_warm cg_steps={int(aux_warm.cg_steps)}")

if "loss" in which:
    fwd = jax.jit(lambda p, c, X, Y: loss_fn(p, c, X, Y)[0])
    bench("loss_fwd", fwd, model.params, carry0, X, Y)

if "lossg" in which:
    def wrapped(p, c, X, Y):
        (l, aux), g = jax.value_and_grad(
            lambda q: loss_fn(q, c, X, Y), has_aux=True)(p)
        s = sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(g))
        return l + 1e-30 * s, aux

    vg = jax.jit(wrapped)
    l, aux = bench("loss_vg cold-v", vg, model.params, carry0, X, Y)
    log(f"  cold-v cg_steps={int(aux.cg_steps)}")
    l, aux2 = bench("loss_vg warm-v", vg, model.params, aux, X, Y)
    log(f"  warm-v cg_steps={int(aux2.cg_steps)}")
print("DONE", flush=True)
