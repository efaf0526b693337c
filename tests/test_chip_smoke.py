"""chip_smoke.py refuses to run without a GPU, or outside a checkout."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_exits_nonzero_without_gpu(tmp_path, where):
    """On the CPU (the test platform) the script exits non-zero and prints no
    result line; copied into a directory that holds nothing else of the repo
    it fails as well."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
