"""The training step: adapter-only or partially frozen training with
optional KL distillation.

One call computes the student forward (with audio), the no-grad text-only
teacher forward (the same LLM weight tree, so the weights exist once on
the card), the loss, gradients for the trainable leaves only (frozen leaves
have ``requires_grad=False`` and get neither a gradient nor optimizer
state), global-norm clipping and the AdamW update. A parameter is trainable
iff its path ("audio_tower/layers/q_proj/lora_a") matches a trainable
pattern (the projector by default).

Unlike the JAX package's functional step, the update is in place: the
trainable tensors and the optimizer's moments are updated where they lie,
and the returned state holds the same tensors. Nothing in a step reads a
number back from the card; the metrics are 0-dim tensors.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from ultravox_torch.inference.engine import resolve_device
from ultravox_torch.models import ultravox as uv
from ultravox_torch.models.config import LossConfig, UltravoxConfig

Params = Any


@dataclasses.dataclass
class TrainState:
    step: int  # updates applied so far (a host number: the schedule reads it)
    trainable: Dict[str, torch.Tensor]  # the optimized leaves, by path
    frozen: Dict[str, torch.Tensor]  # everything else
    opt_state: Any  # the torch.optim.AdamW over ``trainable``


def _path_items(tree: Params, prefix: str = ""):
    """(path, leaf) pairs in the JAX package's flattening order (sorted
    keys), paths joined with "/"."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            yield from _path_items(tree[k], path)
        else:
            yield path, tree[k]


def _map_paths(fn, tree: Params, prefix: str = "") -> Params:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _map_paths(fn, v, path) if isinstance(v, dict) else fn(path, v)
    return out


def trainable_mask(
    params: Params,
    trainable_patterns: Sequence[str] = (r".*projector/.*",),
) -> Params:
    """Bool tree: True where the parameter is optimized."""
    regexes = [re.compile(p) for p in trainable_patterns]
    return _map_paths(
        lambda path, _: any(bool(r.fullmatch(path) or r.match(path)) for r in regexes), params)


def partition_params(params: Params, mask: Params) -> Tuple[Dict, Dict]:
    """Split into flat {path: leaf} dicts (trainable, frozen)."""
    flags = dict(_path_items(mask))
    trainable, frozen = {}, {}
    for path, leaf in _path_items(params):
        (trainable if flags[path] else frozen)[path] = leaf
    return trainable, frozen


def merge_params(params_template: Params, trainable: Dict, frozen: Dict) -> Params:
    """Rebuild the full tree from the two flat dicts."""
    merged = {**frozen, **trainable}
    return _map_paths(lambda path, _: merged[path], params_template)


# --------------------------------------------------------------------------
# optimizer: optax's clip_by_global_norm + adamw with the JAX package's
# schedules, on torch.optim.AdamW
# --------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end; a
    constant ``init`` when steps <= 0."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two schedules."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """AdamW (eps 1e-8 added to sqrt(v-hat), decoupled weight decay) with a
    learning-rate schedule, after clipping by the global norm: gradients
    are scaled by max / norm only when norm >= max, as optax does (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). The lr of update
    n (from 0) is ``schedule(n)``."""

    schedule: Callable[[int], float]
    weight_decay: float
    max_grad_norm: float
    b1: float
    b2: float
    eps: float = 1e-8

    def init(self, trainable: Dict[str, torch.Tensor]) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            list(trainable.values()), lr=self.schedule(0), betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
        )

    @torch.no_grad()
    def update(self, opt: torch.optim.AdamW, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], grad_norm: torch.Tensor, step: int) -> None:
        """One update of ``params`` in place from their (unclipped) grads."""
        if self.max_grad_norm:
            grads = [torch.where(grad_norm < self.max_grad_norm, g,
                                 g / grad_norm.to(g.dtype) * self.max_grad_norm) for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = self.schedule(step)
        opt.step()
        for p in params:
            p.grad = None


def make_optimizer(
    learning_rate: float = 2e-3,
    *,
    schedule: str = "cosine_with_min_lr",
    warmup_steps: int = 1000,
    total_steps: int = 10_000,
    min_lr_rate: float = 0.1,
    weight_decay: float = 0.0,
    max_grad_norm: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.999,
) -> Optimizer:
    """AdamW with linear warmup then cosine decay to ``min_lr_rate x lr``
    (the warmup counts inside ``total_steps``, as optax's
    warmup_cosine_decay_schedule), or "constant" / "linear" after warmup."""
    warmup = _linear(0.0, learning_rate, warmup_steps)
    if schedule == "cosine_with_min_lr":
        decay_steps = max(total_steps, warmup_steps + 1)
        end = learning_rate * min_lr_rate
        alpha = 0.0 if learning_rate == 0.0 else end / learning_rate
        lr = _join(warmup, _cosine(learning_rate, decay_steps - warmup_steps, alpha), warmup_steps)
    elif schedule == "constant":
        lr = _join(warmup, lambda count: learning_rate, warmup_steps)
    elif schedule == "linear":
        lr = _join(warmup, _linear(learning_rate, 0.0, max(total_steps - warmup_steps, 1)),
                   warmup_steps)
    else:
        raise ValueError(f"unknown schedule {schedule}")
    return Optimizer(lr, weight_decay, max_grad_norm, b1, b2)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def init_train_state(
    params: Params,
    optimizer: Optimizer,
    trainable_patterns: Sequence[str] = (r".*projector/.*",),
    *,
    device=None,
) -> Tuple[TrainState, Params]:
    """Returns (state, params_template) on the card, or on ``device``
    ("cpu" runs the plain versions of the kernels). The trainable leaves are
    fresh copies (the caller's tensors are never updated); the template, a
    tree of (shape, dtype), re-merges the flat dicts into the model tree."""
    dev = resolve_device(device)
    mask = trainable_mask(params, trainable_patterns)
    trainable, frozen = partition_params(params, mask)
    trainable = {k: v.detach().to(dev).clone().requires_grad_(True) for k, v in trainable.items()}
    frozen = {k: v.detach().to(dev) for k, v in frozen.items()}
    template = _map_paths(lambda _, v: (tuple(v.shape), v.dtype), params)
    state = TrainState(step=0, trainable=trainable, frozen=frozen,
                       opt_state=optimizer.init(trainable))
    return state, template


def make_train_step(
    cfg: UltravoxConfig,
    loss_config: LossConfig,
    optimizer: Optimizer,
    params_template: Params,
    *,
    remat: bool = True,
    attn_impl: str = "xla",
    vocab_chunk: Optional[int] = None,
    pipe_mesh=None,
) -> Callable:
    """The train step: (state, batch) -> (state, metrics), metrics ``loss``,
    ``grad_norm`` (before clipping) and ``param_norm`` (after the update).
    ``batch`` holds tensors on the state's device."""
    if pipe_mesh is not None:
        raise NotImplementedError("pipeline-parallel training is not ported yet")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = merge_params(params_template, state.trainable, state.frozen)
        loss = uv.ultravox_loss(params, cfg, batch, loss_config, remat=remat,
                                attn_impl=attn_impl, vocab_chunk=vocab_chunk)
        leaves = list(state.trainable.values())
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = global_norm(grads)
        optimizer.update(state.opt_state, leaves, grads, grad_norm, state.step)
        with torch.no_grad():
            param_norm = global_norm(leaves)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_eval_step(
    cfg: UltravoxConfig,
    loss_config: LossConfig,
    params_template: Params,
    *,
    vocab_chunk: Optional[int] = None,
    attn_impl: str = "xla",
    pipe_mesh=None,
) -> Callable:
    """Validation loss step: (state, batch) -> (nll sum, label count), for
    weighted averaging; ``vocab_chunk`` and ``attn_impl`` as in the train
    step."""
    if pipe_mesh is not None:
        raise NotImplementedError("pipeline-parallel evaluation is not ported yet")

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = merge_params(params_template, state.trainable, state.frozen)
        labels = batch["labels"]
        if vocab_chunk:
            hidden = uv.ultravox_forward(params, cfg, batch, return_hidden=True,
                                         attn_impl=attn_impl)
            return uv.chunked_nll_sums(params["language_model"], cfg.text_config, hidden,
                                       labels, chunk=vocab_chunk)
        logits = uv.ultravox_forward(params, cfg, batch, attn_impl=attn_impl)
        shift = labels[:, 1:]
        valid = shift != -100
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, shift, 0).long()[..., None])[..., 0]
        return torch.where(valid, nll, 0.0).sum(), valid.sum()

    return eval_step
