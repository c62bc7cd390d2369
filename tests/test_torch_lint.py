"""The port (`src/repro_torch`) under the repo's own static analyzer,
`tools/saca_lint`, as the reference (`src/repro`) is: no active finding,
and every suppression a live pragma with its reason (``--strict``).

The analyzer runs as CI runs it, ``python -m tools.saca_lint`` from the
root of the checkout.
"""
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def lint(*args):
    return subprocess.run([sys.executable, "-m", "tools.saca_lint", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("mode", ["--check", "--strict"])
def test_port_is_clean_under_saca_lint(mode):
    out = lint(mode, "src/repro_torch")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "saca-lint: 0 failure(s)" in out.stdout, out.stdout


def test_port_suppressions_carry_their_reason():
    """The one suppressed finding is the host-uniform recursion branch of
    Algorithm 3, as in the reference; the tree helpers of the optimizer
    and the checkpoints are iterative and raise none."""
    out = lint("--strict", "src/repro_torch")
    suppressed = [line for line in out.stdout.splitlines()
                  if "[suppressed:" in line]
    assert len(suppressed) == 1, out.stdout
    assert suppressed[0].startswith("src/repro_torch/bsp/suffix_array.py")
    assert "host-uniform" in suppressed[0]
