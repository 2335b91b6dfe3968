"""The control of each serving cell's check, on the card at the cell's own
size: with the float8 (W8A8 e4m3) reference put in the program's place,
the run's own comparison comes out not correct. A short window at the
cell's own load. Run on a machine with a card (``-rA`` shows each run's
result line):

    python -m pytest uvbench/test_uvbench_control.py -m cuda -rA
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (2147484001, 2147484002, 2147484003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["nemo12b-voice-chat", "nemo12b-transcribe"])
def test_the_control_fails_the_check(card, cell, seed):
    out = subprocess.run(
        [sys.executable, "uvbench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", "10", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    print(line)
    print("\n".join(ln for ln in out.stderr.splitlines() if "control:" in ln))
    result = json.loads(line)
    check = result["checks"]["max_gap"]
    assert check["value"] > check["limit"]
    assert result["correct"] is False
