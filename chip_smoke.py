"""Smoke test of the CGLB training path on one NVIDIA GPU (or four).

Run from the root of a checkout:

    python3 chip_smoke.py              # one card: every phase below
    python3 chip_smoke.py --chips 4    # the 4-card sharded phase only

Phases (one card):

1. device      the default JAX device must be a GPU; prints the card's name
               and power limit (nvidia-smi), the JAX version and the
               compile-cache directory.
2. kernels     the compiled Triton streaming matvec vs the dense fp64
               reference p @ K(X) at N = 40,960, D = 8 for both kernel
               families and B in {1, 4}, plus the rectangular cross-matvec
               (13,200 columns); its custom_vjp gradients (var, ls, p) vs
               jax.grad of the dense fp64 form at N = 8,192.  Prints the
               kernel's time beside a plain XLA comparator (a column-tiled
               lax.map of the kernel profile followed by p @ K_tile, in f32 at
               Precision.HIGHEST and in fp64), and one warm loss+gradient of
               the CGLB objective with each operator.
3. main path   through cglb_tpu.backend.Jax: the kin40k synthetic stand-in
               (26,800 train / 13,200 test rows, D = 8), CGLB, Matern32,
               ConditionalVariance init, M = 2,048, fp64; the loss at the
               initial parameters with the streaming and the dense operator;
               5 steps of adam_0.01 and 2 scipy iterations; the metrics,
               which include prediction on the test rows.

With ``--chips 4`` only the sharded phase runs: the CGLB loss and 3 Adam
steps on a 4-device mesh with the streaming operator, the step-0 sharded loss
compared with the one-card loss.

Every check raises on failure, so any failing phase exits non-zero.  Without a
GPU the script exits non-zero before printing any result.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_KERNEL = 40_960
N_GRAD = 8_192
N_TEST = 13_200
D = 8
M = 2_048
KERNEL_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
SHARDED_TOL = 1e-6
PLAIN_TILE = 2_048


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _timed(fn, *args, repeats: int = 5) -> float:
    """Seconds per call of a warm jitted fn (first call excluded)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def phase_device(expect: int):
    import jax

    dev = jax.devices()
    if dev[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev[0].platform!r})",
              file=sys.stderr)
        sys.exit(2)
    if len(dev) < expect:
        print(f"chip_smoke: {expect} GPUs needed, {len(dev)} visible",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    from cglb_tpu import config

    for line in smi.splitlines():
        _log(line)
    _log(f"jax {jax.__version__}; devices {len(dev)} x {dev[0].device_kind}; "
         f"compile cache {config.compilation_cache_dir()}")
    return dev


def _kernel(family: str, rng):
    from cglb_tpu.ops import kernels as k

    return k.make_kernel(family, D, variance=1.3,
                         lengthscales=rng.uniform(0.8, 2.0, size=D),
                         dtype=np.float64)


def _plain_matvec(kern, X, p, dtype):
    """Plain XLA comparator: column tiles of K built by XLA, p @ K_tile."""
    import jax
    import jax.numpy as jnp
    from cglb_tpu.ops import kernels as k

    kern = jax.tree_util.tree_map(lambda a: a.astype(dtype), kern)
    X, p = X.astype(dtype), p.astype(dtype)
    n = X.shape[0]
    tiles = X.reshape(n // PLAIN_TILE, PLAIN_TILE, X.shape[1])
    out = jax.lax.map(
        lambda xt: jnp.dot(p, k.K(kern, X, xt),
                           precision=jax.lax.Precision.HIGHEST), tiles)
    return jnp.moveaxis(out, 0, 1).reshape(p.shape[0], n).astype(jnp.float64)


def _plain_operator(kernel, X, sigma_sq):
    """(K + s2 I) matvec closure built on the plain comparator (fp64)."""
    import jax.numpy as jnp

    def matvec(p):
        n = X.shape[0]
        n_pad = -(-n // PLAIN_TILE) * PLAIN_TILE
        Xp = jnp.pad(X, ((0, n_pad - n), (0, 0)))
        pp = jnp.pad(p, ((0, 0), (0, n_pad - n)))
        return _plain_matvec(kernel, Xp, pp, p.dtype)[:, :n] + sigma_sq * p

    return matvec


def phase_kernels(rng) -> None:
    import jax
    import jax.numpy as jnp
    from cglb_tpu.ops import kernels as k
    from cglb_tpu.ops import matvec_pallas as mv

    X = jnp.asarray(rng.normal(size=(N_KERNEL, D)))
    Xs = jnp.asarray(rng.normal(size=(N_TEST, D)))
    dense_mv = jax.jit(lambda kern, X, p: p @ k.K(kern, X))
    dense_cross = jax.jit(lambda kern, X, Xs, p: p @ k.K(kern, X, Xs))
    for family in ("SquaredExponential", "Matern32"):
        kern = _kernel(family, rng)
        for B in (1, 4):
            p = jnp.asarray(rng.normal(size=(B, N_KERNEL)))
            ref = dense_mv(kern, X, p)
            f = jax.jit(mv.kernel_matvec)
            err = _rel(f(kern, X, p), ref)
            del ref
            _log(f"kernel {family} B={B} N={N_KERNEL}: max|err|/max|ref| "
                 f"= {err:.3e}")
            _check(err <= KERNEL_TOL, f"kernel parity {family} B={B}: {err}")
            t_kernel = _timed(f, kern, X, p)
            t32 = _timed(jax.jit(lambda kern, X, p: _plain_matvec(
                kern, X, p, jnp.float32)), kern, X, p, repeats=3)
            t64 = _timed(jax.jit(lambda kern, X, p: _plain_matvec(
                kern, X, p, jnp.float64)), kern, X, p, repeats=3)
            _log(f"time {family} B={B}: triton kernel {t_kernel * 1e3:.3f} ms"
                 f", plain XLA f32-HIGHEST {t32 * 1e3:.3f} ms, plain XLA "
                 f"fp64 {t64 * 1e3:.3f} ms")
        p = jnp.asarray(rng.normal(size=(1, N_KERNEL)))
        err = _rel(jax.jit(mv.kernel_cross_matvec)(kern, X, Xs, p),
                   dense_cross(kern, X, Xs, p))
        _log(f"cross kernel {family} [{N_KERNEL} x {N_TEST}]: "
             f"max|err|/max|ref| = {err:.3e}")
        _check(err <= KERNEL_TOL, f"cross parity {family}: {err}")

    Xg = X[:N_GRAD]
    p = jnp.asarray(rng.normal(size=(4, N_GRAD)))
    w = jnp.asarray(rng.normal(size=(4, N_GRAD)))
    for family in ("SquaredExponential", "Matern32"):
        kern = _kernel(family, rng)
        g_kernel = jax.jit(jax.grad(
            lambda kk, p, X, w: jnp.sum(mv.kernel_matvec(kk, X, p) * w),
            argnums=(0, 1)))(kern, p, Xg, w)
        g_dense = jax.jit(jax.grad(
            lambda kk, p, X, w: jnp.sum((p @ k.K(kk, X)) * w),
            argnums=(0, 1)))(kern, p, Xg, w)
        for name, a, b in zip(("p", "ls", "var"),
                              jax.tree_util.tree_leaves(g_kernel)[::-1],
                              jax.tree_util.tree_leaves(g_dense)[::-1]):
            err = _rel(a, b)
            _log(f"grad {family} d/d{name} N={N_GRAD}: rel err {err:.3e}")
            _check(err <= GRAD_TOL, f"grad parity {family} {name}: {err}")


def _standin():
    from cglb_tpu.experiments.datasets import get_dataset

    # read no data directory: the kin40k shapes come from the offline
    # stand-in generator
    os.environ["CGLB_DATA_DIR"] = os.path.dirname(os.path.abspath(__file__))
    bundle = get_dataset("Wilson_kin40k")
    _check(bundle.synthetic, "expected the synthetic kin40k stand-in")
    return bundle


def _cglb_model(backend, train, matvec: str = "auto"):
    from cglb_tpu import configs as cfgs

    backend.configure_backend(matvec=matvec)
    cfg = cfgs.CGLBConfig(cfgs.Matern32Config(),
                          cfgs.InducingVariableConfig(M))
    return backend.create_model(cfg, train, seed=0)


def phase_main_path() -> None:
    import jax
    from cglb_tpu.backend import Jax, Model
    from cglb_tpu.models import cglb

    Jax.set_default_float("fp64")
    Jax.set_default_jitter("fp64")
    Jax.set_seed(0)
    bundle = _standin()
    train, test = bundle.to_tuple()
    _log(f"data: kin40k stand-in, train {train[0].shape}, test "
         f"{test[0].shape}")
    t0 = time.perf_counter()
    model = _cglb_model(Jax, train, matvec="streaming")
    _log(f"model: CGLB Matern32 M={M} cv init in "
         f"{time.perf_counter() - t0:.1f} s")

    # the loss at the initial parameters with both operators, same v0 and
    # CG settings
    losses = {}
    for mode in ("streaming", "dense"):
        m = Model(model.kind, model.params, model.data, model.run_cfg,
                  matvec=mode)
        losses[mode] = m.loss_value()
        _log(f"loss[{mode}] at init = {losses[mode]!r} "
             f"(cg steps {m.cg_steps})")
    gap = abs(losses["streaming"] - losses["dense"]) / abs(losses["dense"])
    _log(f"streaming vs dense loss: rel gap {gap:.3e}")
    _check(gap <= LOSS_TOL, f"streaming vs dense loss gap {gap}")

    # one warm loss+gradient with the kernel operator and with the plain one
    fn = model.loss_fn()
    vg = jax.jit(jax.value_and_grad(fn, has_aux=True))
    args = (model.params, model.v0, *model.data)
    t_kernel = _timed(vg, *args, repeats=3)
    (_, aux), _ = vg(*args)
    steps = int(aux.cg_steps)
    cfg = model.run_cfg

    def plain_loss(params, v0, X, Y):
        op = _plain_operator(params.kernel, X, params.noise_variance.value)
        return cglb.loss(params, X, Y, v0, cfg, matvec=op)

    vg_plain = jax.jit(jax.value_and_grad(plain_loss, has_aux=True))
    t_plain = _timed(vg_plain, *args, repeats=3)
    (_, aux_p), _ = vg_plain(*args)
    _log(f"warm loss+grad: triton kernel {t_kernel:.4f} s ({steps} CG "
         f"iterations, {steps / t_kernel:.1f} CG it/s of loss+grad time); "
         f"plain XLA fp64 operator {t_plain:.4f} s "
         f"({int(aux_p.cg_steps)} CG iterations)")

    # train: 5 Adam steps, then 2 scipy iterations, then the metrics
    datasets = bundle.to_tuple()
    for opt, steps_ in (("adam_0.01", 5), ("scipy", 2)):
        t0 = time.perf_counter()
        Jax.optimize(model, datasets, steps_, None, opt)
        _log(f"optimize {opt} x{steps_}: {time.perf_counter() - t0:.1f} s "
             f"(cg steps {model.cg_steps})")
    t0 = time.perf_counter()
    metrics = Jax.metrics_fn(model, datasets)()
    _log(f"metrics in {time.perf_counter() - t0:.1f} s: "
         + json.dumps({k: float(v) for k, v in metrics.items()}))
    _check(all(np.isfinite(float(v)) for v in metrics.values()),
           "non-finite metric")
    elbo, lb, ub = (metrics["elbo"], metrics["cg_lower_bound"],
                    metrics["titsias_upper_bound"])
    _check(elbo <= lb <= ub, f"bracket violated: {elbo} {lb} {ub}")
    _check(metrics["cg/error"] >= 0, "negative cg/error")


def phase_sharded(n_dev: int) -> None:
    from cglb_tpu.backend import Jax, Model
    from cglb_tpu.parallel.mesh import data_mesh

    Jax.set_default_float("fp64")
    Jax.set_default_jitter("fp64")
    Jax.set_seed(0)
    bundle = _standin()
    train, _ = bundle.to_tuple()
    single = _cglb_model(Jax, train, matvec="streaming")
    sharded = Model(single.kind, single.params, train, single.run_cfg,
                    matvec="streaming", mesh=data_mesh(n_dev))
    loss_single = single.loss_value()
    loss_sharded = sharded.loss_value()
    gap = abs(loss_sharded - loss_single) / abs(loss_single)
    _log(f"loss at step 0: one card {loss_single!r}, {n_dev}-card mesh "
         f"{loss_sharded!r}, rel gap {gap:.3e}")
    _check(gap <= SHARDED_TOL, f"sharded vs one-card loss gap {gap}")
    t0 = time.perf_counter()
    Jax.optimize(sharded, bundle.to_tuple(), 3, None, "adam_0.01")
    loss = sharded.loss_value()
    _log(f"3 Adam steps on the {n_dev}-card mesh: "
         f"{time.perf_counter() - t0:.1f} s, loss {loss!r}")
    _check(np.isfinite(loss), "non-finite sharded loss")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase on a 4-card mesh")
    args = ap.parse_args(argv)
    devices = phase_device(args.chips)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if args.chips == 1:
        phase_kernels(rng)
        _log(f"kernels phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_main_path()
        _log(f"main path phase: {time.perf_counter() - t0:.1f} s")
    else:
        phase_sharded(args.chips)
        _log(f"sharded phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
