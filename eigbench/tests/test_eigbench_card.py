"""One short run of each cell on the card, from the command line: exit 0,
a JSON last line, correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from eigbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hpcg27-256.power", "geev-f32-2048.eigvals",
                                  "hpcg27-256.arnoldi"])
def test_short_run_on_the_card(card, name):
    out = subprocess.run([sys.executable, "eigbench/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
