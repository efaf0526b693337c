"""Sweep runner: expands TOML grid files into CLI invocations and runs them.

First-party replacement for the reference's external `xpert` runner
(cglb_experiments/xpert-main.toml:15-35, xpert-ablations.toml:15-69): a TOML
file declares a command template plus per-axis value lists; the cross product
is expanded, `{uid}` is templated into the logdir, and runs execute as
subprocesses with a bounded worker pool (xpert's `num_proc` + `gpu_indices`
pinning becomes one process per card via `CUDA_VISIBLE_DEVICES`, or plain
sequential on a single card).

Grid file format (compatible in spirit with the reference's):

    [sweep]
    cmd = "python -m cglb_tpu.experiments.cli -b jax -t fp64 -l {logdir}/{uid} -s {seed} train -n {num_steps} -d {dataset} cglb -m cglb -k Matern32 -i cv -M {M}"
    logdir = "./logdir"
    num_steps = 2000

    [sweep.grid]
    dataset = ["Wilson_kin40k", "Wilson_pol"]
    M = [1024, 2048]
    seed = [999, 888, 777]

Every key in [sweep.grid] is crossed; scalar keys under [sweep] are constants.
`uid` is auto-built from the grid point (e.g. "dataset=Wilson_pol/M=2048/999").
"""

from __future__ import annotations

import itertools
import os
import shlex
import subprocess
import sys
import threading
import tomllib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import click

__all__ = ["expand_grid", "run_sweep", "main", "detect_accelerators",
           "compile_group_key"]


def expand_grid(spec: Dict) -> List[Dict]:
    """Cross product of [sweep.grid] lists merged over [sweep] constants.

    A file may hold ONE ``[sweep]`` table or SEVERAL ``[[sweep]]`` blocks
    (the reference's xpert format uses multiple ``[[exp]]`` blocks for
    experiment families with different axes, e.g. the cglb-with-voption vs
    cglbn2m ablations at xpert-ablations.toml:17-63); each block expands
    independently and the points concatenate."""
    sweeps = spec.get("sweep", spec)
    if isinstance(sweeps, dict):
        sweeps = [sweeps]
    points = []
    for block in sweeps:
        sweep = dict(block)
        grid = sweep.pop("grid", {})
        keys = list(grid.keys())
        for combo in itertools.product(*(grid[k] for k in keys)):
            point = dict(sweep)
            point.update(dict(zip(keys, combo)))
            uid_parts = []
            for k, v in zip(keys, combo):
                uid_parts.append(f"{k}={v}" if k != "seed" else str(v))
            point.setdefault("uid", "/".join(uid_parts))
            points.append(point)
    return points


def _render(point: Dict) -> str:
    cmd = point["cmd"]
    return cmd.format(**{k: v for k, v in point.items() if k != "cmd"})


def detect_accelerators() -> Tuple[int, str]:
    """(device_count, platform) of the default jax backend, probed in a
    SUBPROCESS that exits before any run starts: a JAX process reserves most
    of a GPU's memory when it first touches it, so the sweep parent must
    stay off JAX or every child run would fail for want of memory.  Returns
    (0, "cpu") when no GPU is reachable."""
    if os.environ.get("JAX_PLATFORMS", "").lower() == "cpu":
        return 0, "cpu"
    try:
        out = subprocess.run(
            [sys.executable, "-c",
             "import jax; d = jax.devices(); print(len(d), d[0].platform)"],
            capture_output=True, text=True, timeout=150,
        )
        n, platform = out.stdout.strip().split()[-2:]
        if platform.lower() == "gpu":
            return int(n), "gpu"
    except (subprocess.TimeoutExpired, ValueError):
        pass
    return 0, "cpu"


def compile_group_key(point: Dict) -> tuple:
    """Points sharing this key compile the SAME XLA programs (they differ
    only by seed), so one of them warms the persistent compile cache for the
    rest.  Everything except the seed/uid identifies the (shape, config)."""
    return tuple(
        (k, str(v)) for k, v in sorted(point.items())
        if k not in ("seed", "uid")
    )


def _point_platform(point: Dict, accel: Tuple[int, str]) -> str:
    """Execution lane for a grid point: an explicit per-block ``platform``
    key wins (e.g. platform = "cpu" for small ablations); otherwise the
    detected accelerator (xpert's gpu_indices analogue:
    cglb_experiments/xpert-main.toml:33-35)."""
    p = str(point.get("platform", "auto")).lower()
    if p != "auto":
        return p
    return accel[1] if accel[0] > 0 else "cpu"


def run_sweep(grid_file, num_proc: int = 1, dry_run: bool = False,
              restart: bool = False, runner=None,
              accel: Optional[Tuple[int, str]] = None) -> int:
    with open(grid_file, "rb") as f:
        spec = tomllib.load(f)
    points = expand_grid(spec)
    jobs = []  # (cmd, point)
    for point in points:
        cmd = _render(point)
        logdir = None
        # skip completed runs unless restart (xpert `restart=false` semantics)
        results_marker = None
        if "-l" in cmd:
            toks = shlex.split(cmd)
            try:
                logdir = toks[toks.index("-l") + 1]
                results_marker = Path(logdir) / "results.json"
            except (ValueError, IndexError):
                pass
        if (not restart and results_marker is not None
                and results_marker.exists()):
            print(f"[skip] {cmd}")
            continue
        # a checkpoint without results marks a killed run: resume it from
        # the checkpoint instead of restarting (CLI --resume; the flag lives
        # on the `train` group, so it goes right after that token)
        if (not restart and logdir is not None
                and Path(logdir, "checkpoint.json").exists()):
            toks = shlex.split(cmd)
            # the GROUP token, not an option value: skip any 'train' whose
            # predecessor is a flag (e.g. `-d train`)
            idx = next(
                (i for i, t in enumerate(toks)
                 if t == "train" and (i == 0 or not toks[i - 1].startswith("-"))),
                None,
            )
            if idx is not None and "--resume" not in toks:
                toks.insert(idx + 1, "--resume")
                cmd = shlex.join(toks)
                print(f"[resume] {cmd}")
        jobs.append((cmd, point))

    if dry_run:
        for cmd, _ in jobs:
            print(cmd)
        return 0
    if not jobs:
        return 0

    if accel is None:
        # ALWAYS detect, even single-worker: the lane decision not only
        # sizes the semaphore, it selects the child env — (0, "cpu") forces
        # JAX_PLATFORMS=cpu on every point, which silently demoted a
        # single-worker on-chip sweep to CPU (observed live, round 5)
        accel = detect_accelerators()
    n_accel = max(accel[0], 0)
    # accelerator lane: at most n_accel concurrent device-bound runs — two
    # JAX processes on one card fail for want of memory (each reserves most
    # of it) or take turns and corrupt timings; CPU-lane points keep the
    # full worker pool.  Each accelerator run is pinned to a free card slot
    # via CUDA_VISIBLE_DEVICES (the xpert gpu_indices analogue), so
    # multi-card hosts fan points out one per card.
    accel_sem = threading.Semaphore(max(n_accel, 1))
    slot_lock = threading.Lock()
    free_slots = list(range(max(n_accel, 1)))

    def _run(job) -> int:
        cmd, point = job
        lane = _point_platform(point, accel)
        env = dict(os.environ)
        slot = None
        if lane == "cpu":
            env["JAX_PLATFORMS"] = "cpu"
        else:
            accel_sem.acquire()
            with slot_lock:
                slot = free_slots.pop()
            if n_accel > 1:
                env["CUDA_VISIBLE_DEVICES"] = str(slot)
        try:
            print(f"[run:{lane}] {cmd}", flush=True)
            if runner is not None:
                rc = runner(cmd, env, lane)
            else:
                rc = subprocess.run(shlex.split(cmd), env=env).returncode
            if rc != 0:
                print(f"[fail rc={rc}] {cmd}", file=sys.stderr)
                return 1
            return 0
        finally:
            if slot is not None:
                with slot_lock:
                    free_slots.append(slot)
                accel_sem.release()

    if num_proc <= 1:
        results = [_run(job) for job in jobs]
        return sum(results)

    # Warm the persistent XLA compilation cache with ONE representative per
    # compile group (points identical up to seed share XLA programs) before
    # fanning out: cold fp64/mixed CGLB compiles are long, and parallel cold
    # starts would each pay that compile.  Multi-[[sweep]] grids get one
    # warm run per distinct (model, M, dataset) group, not just cmds[0].
    seen = set()
    warm, rest = [], []
    for job in jobs:
        key = compile_group_key(job[1])
        if key in seen:
            rest.append(job)
        else:
            seen.add(key)
            warm.append(job)
    results = [_run(job) for job in warm]
    with ThreadPoolExecutor(max_workers=num_proc) as pool:
        results += list(pool.map(_run, rest))
    return sum(results)


@click.command()
@click.argument("grid_file", type=click.Path(exists=True))
@click.option("-p", "--num-proc", default=1, type=int)
@click.option("--dry-run", is_flag=True, default=False)
@click.option("--restart/--no-restart", default=False,
              help="re-run grid points that already have results.json")
def main(grid_file, num_proc, dry_run, restart):
    sys.exit(1 if run_sweep(grid_file, num_proc, dry_run, restart) else 0)


if __name__ == "__main__":
    main()
