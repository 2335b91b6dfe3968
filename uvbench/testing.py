"""Tiny cells for the CPU tests: a checkout in a temporary directory that
holds a copy of this folder, the program (linked), and a BENCHMARK.json of
tiny cells, each a file of its own, as a later change would add them."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

TINY_CONFIG = {
    "source": "a tiny model of the mistral family for CPU tests",
    "reduced": [], "dtype": "float32",
    "model_type": "mistral", "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 2048,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-05, "hidden_act": "silu", "sliding_window": None,
    "tie_word_embeddings": False,
    "audio_config": {"model_type": "whisper", "num_mel_bins": 16, "d_model": 32, "encoder_layers": 2,
                     "encoder_attention_heads": 2, "encoder_ffn_dim": 64,
                     "max_source_positions": 1500},
    "projector": {"hidden_size": 64, "stack_factor": 8, "projector_act": "swiglu",
                  "projector_ln_mid": False, "norm_init": 0.4},
}

TINY_CHAT = {
    "arrival": {"kind": "poisson", "rate_per_s": 6.0}, "warm_session_s": 0.5, "warm_spread_s": 0.5,
    "ramp_s": 1.0, "tail_s": 5.0,
    "agents": {"count": 3, "zipf_s": 1.1, "system_tokens": [40, 80]}, "turns": [2, 3],
    "audio_s": {"dist": "lognormal", "median": 1.0, "sigma": 0.5, "min": 0.5, "max": 2.0},
    "template": {"before_audio": 3, "after_audio": 4}, "transcript_tokens_per_s": 3.5,
    "answer_tokens": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 3, "max": 10},
    "think_s": 0.1, "history": True,
}

TINY_TRANSCRIBE = {
    "arrival": {"kind": "clients", "count": 4, "stagger_s": 0.2}, "ramp_s": 0.5,
    "audio_s": {"dist": "uniform", "min": 1.0, "max": 3.0},
    "template": {"before_audio": 3, "after_audio": 5},
    "answer_tokens": {"per_audio_s": 3.5, "max": 8}, "history": False,
}

TINY_ENGINE = {"num_slots": 4, "max_seq_len": 512, "cache_mode": "paged", "page_size": 16,
               "num_pages": 96, "prefill_chunk_tokens": 32}


def tiny_checkout(tmp: Path, extra_metrics: Dict[str, str] = None) -> Path:
    """A checkout at ``tmp`` with two tiny serving cells (open and closed
    loop) and, for each of ``extra_metrics`` (name -> source of its
    reader), a per-layer metric of both cells."""
    root = Path(tmp)
    shutil.copytree(HERE, root / "uvbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "ultravox_torch", root / "ultravox_torch")
    u = root / "uvbench"
    (u / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (u / "traffic" / "tiny_chat.json").write_text(json.dumps(TINY_CHAT))
    (u / "traffic" / "tiny_transcribe.json").write_text(json.dumps(TINY_TRANSCRIBE))
    for cell in ("tiny-chat", "tiny-transcribe"):
        (u / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"entry": "serve", "engine": TINY_ENGINE, "check": {"sample": 3, "max_gap": 1e-3}}))
    cells = ["tiny-chat", "tiny-transcribe"]
    per_layer = []
    for name, source in (extra_metrics or {}).items():
        (u / "metrics" / f"{name}.py").write_text(source)
        per_layer.append({"name": name, "unit": "%", "better": "higher", "source": "program_counter",
                          "layer": "serving loop", "moves": "output_tok_s", "workloads": cells})
    per_layer.append({"name": "prefix_reuse_share.chat", "unit": "%", "better": "higher",
                      "source": "program_counter", "layer": "serving loop", "moves": "ttft_p95_ms",
                      "workloads": ["tiny-chat"]})
    manifest = {
        "command": ["python3", "uvbench/run.py"], "paths": ["uvbench"], "run_seconds": 2,
        "configs": [{"name": "tiny", "source": "a test", "file": "uvbench/configs/tiny.json",
                     "reduced": [], "why": "CPU test"}],
        "workloads": [
            {"name": "tiny-chat", "config": "tiny", "traffic": "tiny_chat", "chips": 1, "why": "test"},
            {"name": "tiny-transcribe", "config": "tiny", "traffic": "tiny_transcribe", "chips": 1,
             "why": "test"}],
        "end_to_end": [
            {"name": "ttft_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny-chat"]},
            {"name": "tpot_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny-chat"]},
            {"name": "output_tok_s", "unit": "tokens/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny-transcribe"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": per_layer,
    }
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
