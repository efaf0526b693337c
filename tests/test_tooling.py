"""Tests for sweep runner, plotting data layer, names, profiling."""

import json
from pathlib import Path

import numpy as np
import pytest

from cglb_tpu.experiments.names import short_names
from cglb_tpu.experiments.plotting import (
    ExpData,
    Plotter,
    TablePrinter,
    load_experiments,
)
from cglb_tpu.experiments.sweep import expand_grid, run_sweep
from cglb_tpu.utils.profiling import PhaseTimer
from cglb_tpu.utils.serialization import dump_json


def test_expand_grid_cross_product():
    spec = {
        "sweep": {
            "cmd": "echo {dataset} {M} {seed}",
            "grid": {"dataset": ["a", "b"], "M": [1, 2], "seed": [7]},
        }
    }
    points = expand_grid(spec)
    assert len(points) == 4
    assert {(p["dataset"], p["M"]) for p in points} == {
        ("a", 1), ("a", 2), ("b", 1), ("b", 2)
    }
    assert all("uid" in p for p in points)


def test_sweep_dry_run(tmp_path, capsys):
    grid = tmp_path / "grid.toml"
    grid.write_text(
        '[sweep]\ncmd = "echo {x}"\n[sweep.grid]\nx = [1, 2, 3]\n'
    )
    rc = run_sweep(grid, dry_run=True)
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("echo") == 3


def test_sweep_runs_commands(tmp_path):
    marker = tmp_path / "out.txt"
    grid = tmp_path / "grid.toml"
    grid.write_text(
        f'[sweep]\ncmd = "touch {marker}-{{x}}"\n[sweep.grid]\nx = [1, 2]\n'
    )
    rc = run_sweep(grid, num_proc=2)
    assert rc == 0
    assert Path(f"{marker}-1").exists() and Path(f"{marker}-2").exists()


def test_sweep_resumes_killed_points(tmp_path):
    """A point with a checkpoint.json but no results.json was killed
    mid-run: the sweep re-issues it with --resume injected after the
    `train` group token (failure recovery; SURVEY.md 5.4)."""
    killed = tmp_path / "logs" / "killed"
    fresh = tmp_path / "logs" / "fresh"
    killed.mkdir(parents=True)
    fresh.mkdir(parents=True)
    (killed / "checkpoint.json").write_text("{}")
    grid = tmp_path / "grid.toml"
    grid.write_text(
        '[sweep]\ncmd = "cli -l {logdir}/{name} train -n 5 leaf"\n'
        f'logdir = "{tmp_path}/logs"\n'
        "[sweep.grid]\nname = [\"killed\", \"fresh\"]\n"
    )
    cmds = []

    def runner(cmd, env, lane):
        cmds.append(cmd)
        return 0

    rc = run_sweep(grid, runner=runner, accel=(0, "cpu"))
    assert rc == 0
    by_name = {("killed" if "logs/killed" in c else "fresh"): c
               for c in cmds}
    assert "train --resume -n 5 leaf" in by_name["killed"]
    assert "--resume" not in by_name["fresh"]


def _write_fake_run(root, dataset, uid, seed, n_points=30):
    d = Path(root) / dataset / uid / str(seed)
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 1.5, n_points))
    rmse = 1.0 / (1 + 0.2 * np.arange(n_points)) + 0.01 * rng.normal(
        size=n_points
    )
    logs = {
        "iteration": list(range(0, n_points * 20, 20)),
        "elapsed_time": t.tolist(),
        "test/rmse": rmse.tolist(),
        "loss": (100 - 2 * np.arange(n_points)).tolist(),
        "cg/steps-per-feval": rng.integers(1, 40, n_points * 3).tolist(),
    }
    dump_json(logs, d / "logs.json")
    dump_json(
        {"loss": float(logs["loss"][-1]), "test/rmse": float(rmse[-1]),
         "test/nlpd": 0.5, "id": str(d)},
        d / "results.json",
    )


def test_load_experiments_and_table(tmp_path):
    for seed in (1, 2, 3):
        _write_fake_run(tmp_path, "Wilson_pol", "cglb-Matern32-fp64-M1024", seed)
        _write_fake_run(tmp_path, "Wilson_pol", "sgpr-Matern32-fp64-M1024", seed)
    exps = load_experiments(tmp_path)
    assert len(exps) == 6
    cglb_runs = [e for e in exps if e.model == "cglb"]
    assert len(cglb_runs) == 3
    assert cglb_runs[0].num_inducing == 1024
    assert cglb_runs[0].dataset == "Wilson_pol"

    df = TablePrinter(exps).dataframe()
    assert len(df) == 2  # two uids, median over seeds
    s = TablePrinter(exps).print("markdown")
    assert "cglb" in s


def test_plotter_writes_figures(tmp_path):
    import matplotlib

    matplotlib.use("Agg")

    for seed in (1, 2):
        _write_fake_run(tmp_path, "Wilson_pol", "cglb-Matern32-fp64-M512", seed)
    exps = load_experiments(tmp_path)
    ax = Plotter(exps).plot_metric("Wilson_pol", "test/rmse")
    assert len(ax.lines) >= 1
    ax2 = Plotter(exps).plot_cg_steps("Wilson_pol")
    assert len(ax2.lines) >= 1


def test_short_names():
    names = short_names([
        "logs/Wilson_pol/cglb-Matern32-fp64-M2048/999",
        "logs/Wilson_pol/sgprn2m-Matern32-fp64-M1024/1",
    ])
    assert names["logs/Wilson_pol/cglb-Matern32-fp64-M2048/999"] == "CGLB M=2048"
    assert (
        names["logs/Wilson_pol/sgprn2m-Matern32-fp64-M1024/1"]
        == "SGPR-N2M M=1024"
    )


def test_phase_timer():
    pt = PhaseTimer()
    with pt.phase("a"):
        sum(range(10000))
    with pt.phase("a"):
        pass
    with pt.phase("b"):
        pass
    assert pt.counts["a"] == 2
    assert "a" in pt.report()


def test_sweep_compile_group_key():
    from cglb_tpu.experiments.sweep import compile_group_key

    a = {"cmd": "c", "dataset": "pol", "M": 1024, "seed": 999, "uid": "u1"}
    b = {"cmd": "c", "dataset": "pol", "M": 1024, "seed": 777, "uid": "u2"}
    c = {"cmd": "c", "dataset": "pol", "M": 2048, "seed": 999, "uid": "u3"}
    assert compile_group_key(a) == compile_group_key(b)
    assert compile_group_key(a) != compile_group_key(c)


def test_sweep_warms_one_point_per_compile_group(tmp_path):
    """Multi-[[sweep]] grids warm ONE representative per (config, shape)
    group serially before fanning out (ADVICE r2: cmds[0]-only warming left
    other blocks paying simultaneous cold compiles)."""
    import threading

    grid = tmp_path / "grid.toml"
    grid.write_text(
        '[[sweep]]\ncmd = "run {M} {seed}"\n'
        "[sweep.grid]\nM = [1, 2]\nseed = [7, 8]\n"
        '[[sweep]]\ncmd = "run2 {seed}"\n'
        "[sweep.grid]\nseed = [7, 8]\n"
    )
    order = []
    lock = threading.Lock()

    def runner(cmd, env, lane):
        with lock:
            order.append(cmd)
        return 0

    rc = run_sweep(grid, num_proc=4, runner=runner, accel=(0, "cpu"))
    assert rc == 0
    assert len(order) == 6
    # the three distinct compile groups (M=1, M=2, run2) are warmed FIRST
    warm = set(order[:3])
    assert warm == {"run 1 7", "run 2 7", "run2 7"}


def test_sweep_serializes_gpu_lane_on_one_card(tmp_path):
    """With one accelerator card, device-bound points never overlap (a
    second JAX process on the card fails for want of memory or corrupts
    timings); CPU-lane points keep the full pool and get
    JAX_PLATFORMS=cpu."""
    import threading
    import time

    grid = tmp_path / "grid.toml"
    grid.write_text(
        '[[sweep]]\ncmd = "gpu {seed}"\n'
        "[sweep.grid]\nseed = [1, 2, 3, 4]\n"
        '[[sweep]]\ncmd = "cpu {seed}"\nplatform = "cpu"\n'
        "[sweep.grid]\nseed = [1, 2, 3, 4]\n"
    )
    state = {"gpu_now": 0, "gpu_max": 0, "cpu_max": 0, "cpu_now": 0}
    lock = threading.Lock()

    def runner(cmd, env, lane):
        kind = "gpu" if cmd.startswith("gpu") else "cpu"
        if kind == "cpu":
            assert env.get("JAX_PLATFORMS") == "cpu"
        with lock:
            state[f"{kind}_now"] += 1
            state[f"{kind}_max"] = max(state[f"{kind}_max"],
                                       state[f"{kind}_now"])
        time.sleep(0.05)
        with lock:
            state[f"{kind}_now"] -= 1
        return 0

    rc = run_sweep(grid, num_proc=4, runner=runner, accel=(1, "gpu"))
    assert rc == 0
    assert state["gpu_max"] == 1, state  # serialized by construction
    assert state["cpu_max"] >= 2, state  # CPU points ran in parallel


def test_sweep_single_worker_keeps_accelerator_lane(tmp_path):
    """num_proc=1 must still route points to the detected accelerator lane:
    the lane decision selects the child env, and (0, 'cpu') forces
    JAX_PLATFORMS=cpu — which would silently demote a single-worker
    accelerator sweep to CPU."""
    grid = tmp_path / "grid.toml"
    grid.write_text(
        '[sweep]\ncmd = "cli -l {logdir}/{name} train -n 5 leaf"\n'
        f'logdir = "{tmp_path}/logs"\n'
        "[sweep.grid]\nname = [\"a\"]\n"
    )
    lanes, envs = [], []

    def runner(cmd, env, lane):
        lanes.append(lane)
        envs.append(env)
        return 0

    rc = run_sweep(grid, num_proc=1, runner=runner, accel=(1, "gpu"))
    assert rc == 0
    assert lanes == ["gpu"]
    # the gpu lane must not ADD the cpu override (it may inherit whatever
    # the caller's environment already says — conftest pins cpu for tests)
    import os as _os
    assert (envs[0].get("JAX_PLATFORMS")
            == _os.environ.get("JAX_PLATFORMS"))
