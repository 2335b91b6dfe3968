"""Whether the v0.6 Qwen3 recipe's train step moves every trainable leaf.

Three AdamW updates (each two micro-steps of 24 rows, as the KL cell would
run them) of ``ultravox_torch``'s train step on ``uv-qwen3-32b-pp2``, from
the seed, with the optimizer at the end of its warm-up (update 1000 of the
recipe's schedule: lr 1e-4, its peak). First as the recipe states, every
leaf in bfloat16; then, as a second witness, with the trainable leaves in
float32 (the frozen ones still bfloat16). Prints per trainable leaf the
first update's gradient norm (Adam's first moment over 1 - beta1), the norm
of the change after three updates and the share of its elements that
changed, then one JSON line.

    python3 uvbench/probes/train_updates.py --seed N

from the root of a checkout, on the card."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from uvbench import program, spec, weights  # noqa: E402

TRAINABLE = (r".*projector/.*", r".*audio_tower/.*lora_[ab]$")
ROWS, MICRO, UPDATES = 24, 2, 3


def batch(m, rng, dev):
    """One micro-step's rows: 10 s of audio (1000 mel frames, 63 audio
    positions at 12), a 35-token response the loss predicts; the teacher's
    stream has the 35-token transcript in the audio's place."""
    frames, resp, pre = 1000, 35, 12
    n_audio = -(-frames // m.audio_compression)
    T, T2 = pre + n_audio + 4 + resp, pre + resp + 4 + resp
    ids = rng.integers(1000, m.V, (ROWS, T))
    alt = rng.integers(1000, m.V, (ROWS, T2))
    alt[:, -resp:] = ids[:, -resp:]
    labels = np.full((ROWS, T), -100)
    labels[:, -resp:] = ids[:, -resp:]
    alt_labels = np.full((ROWS, T2), -100)
    alt_labels[:, -resp:] = ids[:, -resp:]
    host = {
        "input_ids": ids, "attention_mask": np.ones((ROWS, T), np.int64), "labels": labels,
        "alt_input_ids": alt, "alt_attention_mask": np.ones((ROWS, T2), np.int64),
        "alt_labels": alt_labels,
        "audio_values": (rng.standard_normal((ROWS, m.n_mels, frames)) * 0.5).astype(np.float32),
        "audio_lens": np.full(ROWS, frames, np.int32),
        "audio_token_len": np.full(ROWS, n_audio, np.int32),
        "audio_token_start_idx": np.full(ROWS, pre, np.int32),
        "audio_chunk_batch_idx": np.arange(ROWS, dtype=np.int32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def updates(c, seed, trainable_dtype, dev):
    from ultravox_torch.models.config import LossConfig, LossFunction
    from ultravox_torch.training import train_step as ts

    m = weights.dims(c)
    tree = program.program_tree(weights.make(c, seed, dev, fused=False), c)
    opt = ts.multi_steps(ts.make_optimizer(1e-4, warmup_steps=1000, total_steps=14400), MICRO)
    state, template = ts.init_train_state(tree, opt, TRAINABLE, device=dev)
    del tree
    if trainable_dtype != torch.bfloat16:
        with torch.no_grad():
            state.trainable = {k: v.detach().to(trainable_dtype).requires_grad_(True)
                               for k, v in state.trainable.items()}
        state.opt_state = opt.init(state.trainable)
    state.opt_state.count = 1000
    step = ts.make_train_step(program.program_config(c),
                              LossConfig(loss_function=LossFunction.KL_DIVERGENCE, kl_temperature=2.0),
                              opt, template, remat=True, attn_impl="flash", vocab_chunk=256)
    before = {k: v.detach().clone() for k, v in state.trainable.items()}
    rng = np.random.default_rng(seed)
    grads, losses = {}, []
    t0 = time.monotonic()
    for i in range(UPDATES * MICRO):
        state, metrics = step(state, batch(m, rng, dev))
        losses.append(float(metrics["loss"]))
        if i == MICRO - 1:
            adam = state.opt_state.adamw
            for k, p in state.trainable.items():
                grads[k] = float(adam.state[p]["exp_avg"].float().norm() / (1 - 0.9))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {}
    for k, p in state.trainable.items():
        d = p.detach().float() - before[k].float()
        out[k] = {"numel": p.numel(), "grad_norm": grads[k], "change_norm": float(d.norm()),
                  "moved_share": float((d != 0).float().mean())}
    return out, losses, time.monotonic() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    from ultravox_torch.ops.kernels import _build

    _build.build_all(["flash_attention"])
    c = spec.config("uv-qwen3-32b-pp2")
    dev = torch.device("cuda")
    report = {"seed": args.seed, "card": torch.cuda.get_device_name(dev)}
    for label, dt in (("bf16", torch.bfloat16), ("fp32_trainable", torch.float32)):
        leaves, losses, secs = updates(c, args.seed, dt, dev)
        report[label] = {"leaves": leaves, "losses": losses, "seconds": secs}
        print(f"== {label}: losses {losses} ({secs:.1f} s)", file=sys.stderr)
        for k, v in leaves.items():
            print(f"  {k}: numel {v['numel']} grad {v['grad_norm']:.6g} change {v['change_norm']:.6g} "
                  f"moved {100 * v['moved_share']:.2f}%", file=sys.stderr)
        torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
