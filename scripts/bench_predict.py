"""Prediction-path timing at the kin40k protocol shape: mean+variance for
the full 33% test split (N_test=13,525) at the reference's prediction CG
tolerance (1e-3, cglb/backend/tensorflow/models.py:195), streaming
cross-matvec, hoisted PredictCache (one training-side CG; per-batch work is
cache-reads + cross products only — the reference's PredictCG use_cache
role).  Operands are generated on the device."""
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from cglb_tpu.backend import Model
from cglb_tpu.models import sgpr as sgpr_mod
from cglb_tpu.models.cglb import CGLBConfig
from cglb_tpu.ops import kernels as k


def log(m):
    print(f"# {time.strftime('%H:%M:%S')} {m}", flush=True)


N, D, M, NT = 40960, 8, 2048, 13568
rng = np.random.default_rng(0)
kern = k.make_kernel("Matern32", D, variance=1.0, lengthscales=1.0,
                     dtype=np.float64)
Z = rng.normal(size=(M, D))
params = sgpr_mod.SGPRParams.create(kern, Z, noise_variance=0.5,
                                    dtype=np.float64)
log("making data on device")


@jax.jit
def make_data(key):
    kx, kt, kn = jax.random.split(key, 3)
    X = jax.random.normal(kx, (N, D), dtype=jnp.float64)
    Xt = jax.random.normal(kt, (NT, D), dtype=jnp.float64)
    w = jnp.linspace(0.5, 1.5, D, dtype=jnp.float64)
    Y = jnp.sin(X @ w[:, None]) + 0.5 * jax.random.normal(
        kn, (N, 1), dtype=jnp.float64)
    return X, Xt, Y


X, Xt, Y = make_data(jax.random.PRNGKey(0))
X.block_until_ready()
log("data ready")

model = Model("cglb", params, (X, Y), run_cfg=CGLBConfig(),
              matvec="streaming", common_dtype="mixed")

t0 = time.time()
mean, var = model.predict_f(Xt, cg_tolerance=1e-3)
m0 = float(jnp.sum(mean) + jnp.sum(var))
log(f"predict_f cold (compile + train-side CG + run): {time.time()-t0:.1f} s")
ts = []
for i in range(3):
    t0 = time.time()
    mean, var = model.predict_f(Xt * (1.0 + 1e-13 * i), cg_tolerance=1e-3)
    s = float(jnp.sum(mean) + jnp.sum(var))
    ts.append(time.time() - t0)
log(f"predict_f warm (mean+var, NT={NT}, tol 1e-3): {min(ts):.3f} s min "
    f"/ {np.mean(ts):.3f} s mean")
assert np.isfinite(s) and np.isfinite(m0)
print("DONE", flush=True)
