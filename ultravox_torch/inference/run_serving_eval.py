"""Serve-and-score harness: the port's continuous-batching HTTP server
started in this process, driven through the OpenAI protocol by
``tools.infer_api.OpenAIInference`` (as an outside client would), and the
answers scored with the evaluation suite's metric registries.

CLI (the CUDA card in bf16, or ``--device cpu`` in fp32):

    python -m ultravox_torch.inference.run_serving_eval --model <dir> \\
        --eval_sets "[librispeech-clean-transcription]" [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import torch
import yaml

logger = logging.getLogger(__name__)


def start_server(model_dir: str, num_slots: int, max_seq_len: int, port: int = 0, *,
                 device=None):
    """Load the checkpoint ``model_dir`` (a directory, ``hf://`` or
    ``wandb://``) with its tokenizer, start a ``ServingEngine`` of
    ``num_slots`` slots and an HTTP server on 127.0.0.1:``port`` (0 picks
    a free one) on a thread. The weights and the KV cache are bf16 on the
    card and fp32 on the CPU. Returns (server, engine,
    port); the caller ends them with ``server.shutdown()`` and
    ``engine.stop()``."""
    from ultravox_torch.inference.engine import resolve_device
    from ultravox_torch.inference.serving.api_server import ServingAPI, make_handler
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.inference.ultravox_infer import load_ultravox_checkpoint
    from ultravox_torch.models.processor import DataCollatorWithAudio, make_processor
    from ultravox_torch.models.tokenizer import load_tokenizer

    dev = resolve_device(device)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    cfg, params, model_dir = load_ultravox_checkpoint(model_dir, dtype, device=dev)
    tokenizer = load_tokenizer(model_dir)
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token = tokenizer.eos_token
    processor = make_processor(tokenizer, cfg)
    engine = ServingEngine(params, cfg, num_slots=num_slots, max_seq_len=max_seq_len,
                           cache_dtype=dtype, device=dev)
    api = ServingAPI(engine, processor, DataCollatorWithAudio(
        pad_token_id=tokenizer.pad_token_id, max_audio_len=processor.audio_context_size or 3000))
    engine.start()
    try:
        server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(api))
    except Exception:
        engine.stop()
        raise
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, engine, server.server_address[1]


def wait_healthy(port: int, timeout_s: float = 60.0) -> None:
    """Poll ``/health`` until it answers ``{"status": "ok"}``."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                if json.load(r).get("status") == "ok":
                    return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError("server did not become healthy")


def main(argv=None):
    from ultravox_torch.evaluation.eval import EvalConfig, eval_datasets
    from ultravox_torch.tools.infer_api import OpenAIInference

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--eval_sets", required=True)
    parser.add_argument("--num_samples", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_tokens", type=int, default=256)
    parser.add_argument("--num_slots", type=int, default=16)
    parser.add_argument("--max_seq_len", type=int, default=4096)
    parser.add_argument("--output_dir", default="serving_eval_results")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card, in bf16 (cpu: fp32)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    server, engine, port = start_server(args.model, args.num_slots, args.max_seq_len,
                                        device=args.device)
    try:
        wait_healthy(port)
        client = OpenAIInference(f"http://127.0.0.1:{port}")
        config = EvalConfig(
            eval_sets=yaml.safe_load(args.eval_sets),
            num_samples=args.num_samples,
            batch_size=args.batch_size,
            max_tokens=args.max_tokens,
            output_dir=args.output_dir,
        )
        scores = eval_datasets(client, config)
        print(json.dumps(scores, indent=2))
        return scores
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
