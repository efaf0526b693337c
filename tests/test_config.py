"""Process-wide settings made by cglb_tpu.config at import."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = ("import jax, cglb_tpu; from cglb_tpu import config; "
          "print(jax.config.jax_compilation_cache_dir); "
          "print(config.compilation_cache_dir()); "
          "print(jax.config.jax_default_matmul_precision)")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and the code sets no
    other.  Unset: the checkout's own .jax_cache/."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT)
    want = str(ROOT / ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300,
                         check=True)
    jax_dir, reported, precision = out.stdout.split()
    assert jax_dir == want
    assert reported == want
    assert precision == "highest"
