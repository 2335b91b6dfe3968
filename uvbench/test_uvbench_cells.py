"""Tiny cells end to end on the CPU through the port's plain paths, in a
checkout made in a temporary directory: the result line's shape, a metric
and a cell added as files alone, the exits without a card or without the
program, and planted faults that the check must catch."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from uvbench import testing

DUMMY_METRIC = '''"""A metric added as a file alone: the decode dispatches of the span."""


def read(run):
    return run.counter("stat_decode_dispatches")
'''
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(root: Path, *args, device="cpu", timeout=300):
    cmd = [sys.executable, "uvbench/run.py", *args]
    if device:
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout, env=env)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return testing.tiny_checkout(tmp_path_factory.mktemp("checkout"),
                                 extra_metrics={"dummy_dispatches": DUMMY_METRIC})


@pytest.mark.parametrize("cell,trace", [("tiny-chat", 0), ("tiny-transcribe", 0), ("tiny-chat", 1)])
def test_tiny_cell_prints_a_result_line(checkout, cell, trace):
    out = _run(checkout, "--workload", cell, "--seed", str(2**31 + 11), "--seconds", "2",
               "--trace", str(trace))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= result.keys() and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    names = set(result["metrics"])
    if trace:
        assert "dummy_dispatches" in names and result["metrics"]["dummy_dispatches"]["value"] > 0
        assert {"busy_s", "window_s"} <= result["device"].keys()
        assert "setup_s" not in names
    else:
        assert "setup_s" in names and "dummy_dispatches" not in names
        assert ("ttft_p95_ms" in names) == (cell == "tiny-chat")
        assert ("output_tok_s" in names) == (cell == "tiny-transcribe")
    assert out.stderr.rstrip().splitlines()[-1].startswith("check max_gap:")


def test_no_card_no_result(checkout):
    out = _run(checkout, "--workload", "tiny-chat", "--seed", "1", "--seconds", "1", device=None)
    if out.returncode == 0:  # a machine with a card runs it
        pytest.skip("this machine has a CUDA card")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path, checkout):
    shutil.copytree(checkout / "uvbench", tmp_path / "uvbench")
    shutil.copy(checkout / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, "--workload", "tiny-chat", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""


def _in_process(monkeypatch, capsys, root: Path, cell: str, *extra: str):
    """One run of the harness in this process: the program is this
    repository's (already imported), the cells and files ``root``'s."""
    from uvbench import run, spec

    monkeypatch.setattr(run, "ROOT", testing.REPO)
    monkeypatch.setattr(spec, "manifest", lambda _: json.loads((root / "BENCHMARK.json").read_text()))
    # pytest's plugins may load JAX into this process; the subprocess runs
    # above hold the harness to its check
    monkeypatch.setattr(run, "forbidden_loaded", lambda: [])
    monkeypatch.setattr(spec, "HERE", root / "uvbench")
    code = run.main(["--workload", cell, "--seed", "5", "--seconds", "2", "--device", "cpu", *extra])
    out = capsys.readouterr().out.strip().splitlines()
    return code, json.loads(out[-1]) if out else None


@pytest.mark.parametrize("cell", ["tiny-chat", "tiny-transcribe"])
def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch, capsys, checkout, cell):
    from ultravox_torch.inference.serving import engine

    emit = engine.ServingEngine._emit

    def altered(self, req, token_id, lp=None):
        if req.generated == 1:  # the second token of every turn
            token_id = (token_id + 1) % self.cfg.text_config.vocab_size
        return emit(self, req, token_id, lp)

    monkeypatch.setattr(engine.ServingEngine, "_emit", altered)
    code, result = _in_process(monkeypatch, capsys, checkout, cell)
    assert code == 0 and result["correct"] is False
    assert result["checks"]["max_gap"]["value"] > result["checks"]["max_gap"]["limit"]


def test_the_unaltered_run_in_process_is_correct(monkeypatch, capsys, checkout):
    code, result = _in_process(monkeypatch, capsys, checkout, "tiny-chat")
    assert code == 0 and result["correct"] is True



def test_the_control_is_compared_in_the_programs_place(monkeypatch, capsys, checkout):
    """With ``--control 1`` the run's own comparison judges the float8
    reference's tokens. At the tiny size float8 picks the exact tokens, so
    its logits are turned over here: the token it puts first is then the
    reference's last, and the run must come out not correct."""
    from uvbench.reference import plain

    served_logits = plain.served_logits

    def turned(w, m, ids, mel, start, served, p=plain.EXACT):
        out = served_logits(w, m, ids, mel, start, served, p)
        return -out if p is plain.FP8 else out

    monkeypatch.setattr(plain, "served_logits", turned)
    code, result = _in_process(monkeypatch, capsys, checkout, "tiny-chat", "--control", "1")
    assert code == 0 and result["correct"] is False
    assert result["checks"]["max_gap"]["value"] > result["checks"]["max_gap"]["limit"]
