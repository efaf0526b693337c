"""AOT-compile the sharded CGLB training step at large-N shapes.

Proves the multi-device training graph (parallel/sharded.sharded_train_step,
streaming Pallas matvec, gram-form common terms) compiles at houseelectric-
class shapes (SURVEY.md 5.7; houseelectric: N=2,049,280, D=11, M=1024) and
reports XLA's own per-device memory analysis — without needing N real cards
or executing the step.  Reference role: the MultiDeviceKernel large-N data
parallelism, cglb/backend/pytorch/interface.py:241-244.

Run on a virtual CPU mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/large_n_aot.py --n 1373184 --d 11 --m 1024 --devices 8

Prints one JSON line with compile wall time and the memory breakdown.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1373184,
                    help="training rows (default: houseelectric 67%% split)")
    ap.add_argument("--d", type=int, default=11)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--block", type=int, default=None,
                    help="streaming block size (default: the kernel's)")
    ap.add_argument("--matvec", default="streaming",
                    choices=["streaming", "dense"])
    ap.add_argument("--execute", action="store_true",
                    help="also run ONE step (slow in interpret mode; off by "
                         "default — the artifact is the compile + memory "
                         "analysis)")
    ap.add_argument("--steps", type=int, default=1,
                    help="with --execute: number of optimizer steps to run "
                         "(>=5 is the large-N training proof; each step is "
                         "its own device dispatch so the watchdog bound "
                         "applies per step, not to the whole run)")
    ap.add_argument("--bounded", type=int, default=0, metavar="IPD",
                    help="use the dispatch-bounded step (parallel/dispatch."
                         "bounded_train_step) with IPD CG iterations per "
                         "device dispatch instead of the monolithic AOT "
                         "step — full CG depth under a per-dispatch "
                         "watchdog (no memory_analysis in this mode; "
                         "compile is folded into step-0 wall)")
    ap.add_argument("--max-cg-iters", type=int, default=100,
                    help="CG iteration cap.  At N~1M each CG iteration is a "
                         "multi-second streaming matvec, and an uncapped "
                         "100-iteration solve puts minutes inside ONE device "
                         "dispatch; cap it for the execute proof.")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from cglb_tpu.models import cglb as cglb_mod
    from cglb_tpu.models import sgpr as sgpr_mod
    from cglb_tpu.ops import kernels as k
    from cglb_tpu.parallel import mesh as mesh_mod
    from cglb_tpu.parallel import sharded

    devs = jax.devices()
    assert len(devs) >= args.devices, (
        f"need {args.devices} devices, have {len(devs)} "
        "(set --xla_force_host_platform_device_count)")
    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    mesh = mesh_mod.data_mesh(args.devices)

    # Inputs at full shape.  X/Y content is irrelevant to compilation, but
    # --execute needs non-degenerate data (N identical points make the
    # kernel system rank-1 and the executed loss NaNs) — generate it on
    # device to keep host memory/transfer out of the measurement.
    rng = np.random.default_rng(0)
    if args.execute:
        @jax.jit
        def _mk(key):
            kx, kn = jax.random.split(key)
            Xd = jax.random.normal(kx, (args.n, args.d), dtype=dtype)
            w = jnp.linspace(0.5, 1.5, args.d, dtype=dtype)
            Yd = jnp.sin(Xd @ w[:, None]) + 0.3 * jax.random.normal(
                kn, (args.n, 1), dtype=dtype)
            return Xd, Yd

        X, Y = _mk(jax.random.PRNGKey(0))
    else:
        X = np.zeros((args.n, args.d), dtype=dtype)
        Y = np.zeros((args.n, 1), dtype=dtype)
    kern = k.make_kernel("Matern32", args.d, dtype=dtype)
    Z = rng.normal(size=(args.m, args.d)).astype(dtype)
    params = sgpr_mod.SGPRParams.create(kern, Z, noise_variance=0.5,
                                        dtype=dtype)
    v0 = cglb_mod.init_v0(args.n, dtype=dtype)
    cfg = cglb_mod.CGLBConfig(max_error=1.0, max_cg_iters=args.max_cg_iters)

    Xs, Ys = sharded.shard_data(mesh, jnp.asarray(X), jnp.asarray(Y))
    opt = optax.adam(0.01)
    opt_state = opt.init(params)

    rec = {
        "n": args.n, "d": args.d, "m": args.m,
        "devices": args.devices, "matvec": args.matvec,
        "block": args.block, "platform": devs[0].platform,
    }

    if args.bounded:
        from cglb_tpu.parallel import dispatch as dispatch_mod

        rec["bounded_iters_per_dispatch"] = args.bounded
        compiled = dispatch_mod.bounded_train_step(
            cfg, opt, mesh=mesh, matvec=args.matvec, block=args.block,
            iters_per_dispatch=args.bounded)
        mem = None
    else:
        step = sharded.sharded_train_step(mesh, cfg, opt,
                                          matvec=args.matvec,
                                          block=args.block)
        t0 = time.perf_counter()
        lowered = step.lower(params, opt_state, v0, Xs, Ys)
        rec["lower_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        compiled = lowered.compile()
        rec["compile_s"] = round(time.perf_counter() - t0, 2)
        mem = compiled.memory_analysis()
    if mem is not None:
        for key in ("argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes",
                    "alias_size_in_bytes"):
            val = getattr(mem, key, None)
            if val is not None:
                rec[key.replace("_in_bytes", "_gib")] = round(val / 2**30, 3)
        total = sum(getattr(mem, key, 0) or 0
                    for key in ("argument_size_in_bytes",
                                "temp_size_in_bytes",
                                "output_size_in_bytes"))
        rec["peak_estimate_gib"] = round(total / 2**30, 3)

    if args.execute:
        state = (params, opt_state, v0)
        losses, step_walls, cg_steps = [], [], []
        dispatch_walls = []  # bounded path: wall per CG chunk dispatch
        for i in range(args.steps):
            t0 = time.perf_counter()
            if args.bounded:
                chunk_t = [t0]

                def _cb(steps_done, stats, _ts=chunk_t):
                    now = time.perf_counter()
                    _ts.append(now)
                    print(f"#   chunk -> cg={steps_done} "
                          f"({now - _ts[-2]:.2f} s)", flush=True)

                p2, o2, aux, loss = compiled(*state, Xs, Ys,
                                             chunk_callback=_cb)
                dispatch_walls.append(
                    [round(b - a, 2)
                     for a, b in zip(chunk_t, chunk_t[1:])])
            else:
                p2, o2, aux, loss = compiled(*state, Xs, Ys)
            loss = float(loss)
            step_walls.append(round(time.perf_counter() - t0, 2))
            losses.append(round(loss, 4))
            cg_steps.append(int(aux.cg_steps))
            state = (p2, o2, aux.v)
            print(f"# step {i}: {step_walls[-1]} s  loss={loss:.4f}  "
                  f"cg={cg_steps[-1]}", flush=True)
        rec["step_s"] = step_walls[0]
        rec["step_walls"] = step_walls
        if dispatch_walls:
            rec["dispatch_walls"] = dispatch_walls
            rec["max_dispatch_s"] = max(
                (w for ws in dispatch_walls for w in ws), default=None)
        rec["losses"] = losses
        rec["cg_steps"] = cg_steps
        rec["loss_finite"] = bool(np.isfinite(losses[-1]))
        rec["loss_decreased"] = bool(losses[-1] < losses[0])

    print(json.dumps(rec))


if __name__ == "__main__":
    main()
