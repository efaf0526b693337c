"""Benchmark of the CG hot op and one training feval on one NVIDIA GPU.

Measures, at the kin40k shape (N=40960, D=8, Matern32, fp64 data):

- the streaming kernel matvec (ops/matvec_pallas), chained inside one jit so
  the coordinate preparation is hoisted exactly as in the CG loop;
- the dense fp64 XLA matvec (K materialized, the reference TF backend's
  scheme) at N=8192, compared rate for rate (``vs_baseline``);
- preconditioned CG iterations per second at M=2048;
- one warm loss+grad of the CGLB objective (scripts/bench_feval.py), in this
  same process — a second JAX process could not get the card's memory.

Refuses to run (exit code 2) unless the first JAX device is a GPU.  Prints
ONE JSON line:
    {"metric": "cg_matvec_tflops", "value": <2 N^2 / t / 1e12>, "unit":
     "TFLOP/s", "vs_baseline": <streaming rate / dense-fp64 XLA rate>,
     "detail": {...}}
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def _bench(fn, *args, iters=5, warmup=2):
    """Seconds per call of a jitted fn, waiting for the device each time."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(2)
    import jax.numpy as jnp

    from cglb_tpu.models import sgpr as sgpr_mod
    from cglb_tpu.ops import cg as cg_mod
    from cglb_tpu.ops import kernels as k
    from cglb_tpu.ops import matvec_pallas as mv
    from cglb_tpu.ops import preconditioners as pc

    def stage(msg):
        print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr,
              flush=True)

    n, d, m, chain = 40960, 8, 2048, 10
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.normal(size=(n, d)))
    p = jnp.asarray(rng.normal(size=(1, n)))
    kern = k.make_kernel("Matern32", d, dtype=np.float64)

    # large operands cross the jit boundary as arguments: closed-over arrays
    # would be embedded in the program as constants
    def chained(p, X, kern):
        op = mv.make_streaming_operator(kern, X, jnp.asarray(0.0))
        return jax.lax.fori_loop(0, chain, lambda i, q: op(q) / n, p)

    t_stream = _bench(jax.jit(chained), p, X, kern) / chain
    tflops = 2.0 * n * n / t_stream / 1e12
    stage(f"streaming matvec {t_stream * 1e3:.3f} ms")

    nb = 8192

    def dense_chained(p, Xb, kern):
        Kmat = k.K(kern, Xb)
        return jax.lax.fori_loop(0, chain, lambda i, q: (q @ Kmat) / nb, p)

    t_dense = _bench(jax.jit(dense_chained), p[:, :nb], X[:nb], kern,
                     iters=3, warmup=1) / chain
    dense_rate = 2.0 * nb * nb / t_dense
    stage(f"dense fp64 baseline {t_dense * 1e3:.3f} ms at n={nb}")

    Z = np.asarray(X)[np.random.default_rng(1).choice(n, m, replace=False)]
    params = sgpr_mod.SGPRParams.create(kern, Z, noise_variance=0.1,
                                        dtype=np.float64)
    ct = jax.jit(lambda pp, X: sgpr_mod.common_terms(pp, X, mixed=True))(
        params, X)
    b = jnp.asarray(rng.normal(size=(1, n)))

    @jax.jit
    def run_cg(b, X, ct, params):
        sigma_sq = params.noise_variance.value
        precond = pc.NystromPreconditioner(
            A=ct.A.astype(jnp.float32), LB=ct.LB.astype(jnp.float32),
            sigma_sq=sigma_sq, Ci=ct.LBi.astype(jnp.float32))
        op = mv.make_streaming_operator(params.kernel, X, sigma_sq)
        return cg_mod.preconditioned_cg(op, b, jnp.zeros_like(b), precond,
                                        max_error=0.0, max_iters=50)

    jax.block_until_ready(run_cg(b, X, ct, params))
    t0 = time.perf_counter()
    _, stats = jax.block_until_ready(run_cg(b, X, ct, params))
    iters_per_s = int(stats.steps) / (time.perf_counter() - t0)
    stage(f"CG {iters_per_s:.1f} it/s")

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    from bench_feval import measure_feval

    feval = measure_feval(log=stage)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "metric": "cg_matvec_tflops",
        "value": tflops,
        "unit": "TFLOP/s",
        "vs_baseline": (2.0 * n * n / t_stream) / dense_rate,
        "detail": {
            "shape": {"N": n, "D": d, "M": m},
            "matvec_ms": t_stream * 1e3,
            "dense_fp64_baseline_tflops": dense_rate / 1e12,
            "cg_iters_per_s": iters_per_s,
            **feval,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": smi,
        },
    }))


if __name__ == "__main__":
    main()
