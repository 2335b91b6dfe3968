"""Checkpointing: adapter-sized diff checkpoints + resume.

As in the reference (SURVEY.md §5), a checkpoint holds only what training
changes, so it is adapter-sized:

- ``save_checkpoint`` writes ``checkpoint-<step>/state.pt``: the micro-step,
  the trainable leaves by path, the AdamW ``state_dict``, the update count
  and, with gradient accumulation, the micro-steps since the last update
  and the gradients' running mean (the frozen backbone is NOT saved: it
  reloads from its source checkpoint);
- ``restore_checkpoint`` loads one into a same-shaped ``TrainState`` on
  that state's device, with an AdamW of the state's class bound to the
  restored tensors (its ``state_dict`` brings the settings and moments);
- ``export_safetensors`` writes the trainable projector in HF/fixie naming,
  fp32, so the reference implementation can load it.

The JAX package writes orbax directories; this format is the port's own.

A checkpoint does not depend on the number of processes that wrote it:
over an fsdp, tensor and pipe mesh every process joins the gathers of its
leaves' parts (leaves, AdamW moments, accumulation buffer: over fsdp,
then over tensor, then a stage's layers over pipe), the master writes
exactly what one process writes,
and all meet at a barrier; a restore reads the whole file on every
process and cuts each part again from the state it is given. The export
is the master's, after the same gathers.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Dict, Optional

import torch

from ultravox_torch.models.weights import save_safetensors
from ultravox_torch.parallel.collectives import is_global_master, sync_hosts
from ultravox_torch.parallel.sharding import carry_shard, cut_as, full_shape, gather_as, is_placed
from ultravox_torch.training.train_step import OptState, TrainState

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(os.path.abspath(base), f"checkpoint-{step}")


def _whole_adamw(adamw: torch.optim.Optimizer, leaves) -> Dict:
    """The AdamW state dict with each part's moments gathered whole."""
    sd = adamw.state_dict()
    for i, p in enumerate(leaves):
        if is_placed(p) and i in sd["state"]:
            sd["state"][i] = {k: gather_as(v, p) if v.shape == p.shape and v.dim() else v
                              for k, v in sd["state"][i].items()}
    return sd


def save_checkpoint(base_dir: str, state: TrainState) -> str:
    """Write ``checkpoint-<step>``; every process of the run must call it."""
    path = _ckpt_dir(base_dir, state.step)
    # every process looks before the master writes: one that looked after
    # the write would skip the barrier below that the others wait at
    done = os.path.exists(path)
    sync_hosts("checkpoint")
    if done:  # idempotent per step (e.g. save_steps + final)
        return path
    opt = state.opt_state
    leaves = list(state.trainable.values())
    payload = {
        "step": state.step,
        "trainable": {k: gather_as(v, v).detach() for k, v in state.trainable.items()},
        "adamw": _whole_adamw(opt.adamw, leaves),
        "count": opt.count,
        "mini_step": opt.mini_step,
        "acc": None if opt.acc is None else [gather_as(a, p) for a, p in zip(opt.acc, leaves)],
    }
    if is_global_master():
        # write beside, then rename: a cut save leaves no checkpoint-<step>
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        os.replace(tmp, path)
    sync_hosts("checkpoint")
    return path


def latest_checkpoint(base_dir: str) -> Optional[str]:
    if not os.path.isdir(base_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(base_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(base_dir, name), int(m.group(1))
    return best


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """The checkpoint at ``path`` in the structure of ``state``, on the
    device of its trainable leaves, each part cut from the whole as the
    state's leaf is; ``state`` itself is left as it was."""
    leaves = list(state.trainable.values())
    dev = leaves[0].device if leaves else torch.device("cpu")
    # on the host first: AdamW keeps its step counts there, and
    # load_state_dict moves the moments to their parameters' device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    saved = payload["trainable"]
    if set(saved) != set(state.trainable):
        raise ValueError(
            f"checkpoint {path} holds other trainable leaves than the state: "
            f"{sorted(set(saved) ^ set(state.trainable))[:8]}")
    trainable = {}
    for k, cur in state.trainable.items():
        if tuple(saved[k].shape) != full_shape(cur) or saved[k].dtype != cur.dtype:
            raise ValueError(f"checkpoint {path}: {k} is {saved[k].dtype} "
                             f"{tuple(saved[k].shape)}, the state's {cur.dtype} {full_shape(cur)}")
        trainable[k] = carry_shard(cur, cut_as(saved[k], cur).to(dev, copy=True)
                                   .requires_grad_(True))
    cur_leaves = list(state.trainable.values())
    adamw_sd = payload["adamw"]
    for i, p in enumerate(cur_leaves):
        if is_placed(p) and i in adamw_sd["state"]:
            adamw_sd["state"][i] = {k: cut_as(v, p) for k, v in adamw_sd["state"][i].items()}
    # the saved param groups carry every setting (lr, betas, eps, decay)
    adamw = type(state.opt_state.adamw)(list(trainable.values()))
    adamw.load_state_dict(adamw_sd)
    acc = payload["acc"]
    if acc is not None:
        acc = [cut_as(a, p).to(dev) for a, p in zip(acc, cur_leaves)]
    if (acc is None) != (state.opt_state.acc is None):
        raise ValueError(f"checkpoint {path} was written with another grad_accum_steps")
    opt = OptState(adamw, count=payload["count"], mini_step=payload["mini_step"], acc=acc)
    return dataclasses.replace(state, step=payload["step"], trainable=trainable, opt_state=opt)


# -- HF-compatible export ----------------------------------------------------


def export_safetensors(state: TrainState, out_path: str) -> Dict[str, torch.Tensor]:
    """Write the trainable subtree as an HF-naming safetensors file the
    reference can load (projector keys under ``multi_modal_projector.``,
    linear weights as (out, in), fp32). Every process of the run must call
    it (shards are gathered); the master writes."""
    out: Dict[str, torch.Tensor] = {}
    skipped = []
    for path, leaf in state.trainable.items():
        # only the projector subtree has a faithful HF-name mapping here;
        # layer-stacked decoder/encoder leaves and LoRA factors need the full
        # un-stacking export in tools/publish.save_pretrained
        if not path.startswith("projector/"):
            skipped.append(path)
            continue
        t = gather_as(leaf, leaf).detach().to("cpu", torch.float32)
        name = _hf_name(path)
        if name.endswith((".linear_1.weight", ".linear_2.weight")):
            t = t.T  # our kernels are (in, out); HF stores (out, in)
        out[name] = t.contiguous()
    if skipped:
        logger.warning(
            "export_safetensors: %d non-projector trainable leaves not "
            "exported in HF naming (use tools.publish.save_pretrained for a "
            "full checkpoint): %s", len(skipped), skipped[:4],
        )
    if is_global_master():
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        save_safetensors(out, out_path)
    sync_hosts("export")
    return out


def _hf_name(path: str) -> str:
    """Map our flat param path to the reference's state-dict name."""
    name = path
    name = name.replace("projector/", "multi_modal_projector.")
    name = name.replace("audio_tower/", "audio_tower.")
    name = name.replace("language_model/", "language_model.model.")
    name = name.replace("/kernel", ".weight").replace("/bias", ".bias")
    name = name.replace("/", ".")
    if name.startswith("multi_modal_projector.") and not name.endswith(
        (".weight", ".bias")
    ):
        name = name + ".weight"  # bare rmsnorm leaves
    return name
