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

Gradient accumulation (``multi_steps``) follows ``optax.MultiSteps``: each
call is one micro-step (``TrainState.step`` counts them, as the JAX
package's does); the gradients' running mean lives in fp32 buffers beside
the optimizer, and clipping and the AdamW update run on that mean every
k-th call only. The schedule counts updates (``OptState.count``).

Over several processes (``mesh``), each process runs its own rows of the
global batch (tensor and pipe peers the same rows): the loss is its share
of the global batch's (``models/ultravox.py``), the gradients are summed over
the processes that hold the same leaf and split the batch
(``parallel/sharding.py::reduce_gradients``; a fsdp shard's gather
already summed it over its group, and tensor peers hold other slices or
the same whole gradient), and the norms count every element of the whole
leaves once. A shard's AdamW moments and accumulation buffer are the
shard's own.

With pipeline stages (``pipe_mesh``, a mesh with pipe > 1) the decoder
layer stack runs as a GPipe schedule (``parallel/pipeline.py``): each
stage holds and trains its own layers, the loss is the last stage's, a
leaf every stage holds gets the sum of the stages' parts of its gradient,
and the loss metric (and the validation sums) are summed over ``pipe``,
so every process reads the global batch's.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ultravox_torch.inference.engine import resolve_device
from ultravox_torch.models import ultravox as uv
from ultravox_torch.models.config import LossConfig, UltravoxConfig
from ultravox_torch.parallel.mesh import Mesh
from ultravox_torch.parallel.sharding import all_reduce_, carry_shard, reduce_gradients, sq_sum
from ultravox_torch.parallel.sharding import map_paths as _map_paths
from ultravox_torch.parallel.sharding import path_items as _path_items

Params = Any


@dataclasses.dataclass
class OptState:
    """The optimizer's state: AdamW over the trainable leaves, the updates
    applied so far (the schedule reads it), and, with accumulation, the
    micro-steps since the last update and the gradients' running mean."""

    adamw: torch.optim.AdamW
    count: int = 0
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None  # fp32, one per trainable leaf


@dataclasses.dataclass
class TrainState:
    step: int  # micro-steps taken so far (train_step calls)
    trainable: Dict[str, torch.Tensor]  # the optimized leaves, by path
    frozen: Dict[str, torch.Tensor]  # everything else
    opt_state: OptState


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
    n (from 0) is ``schedule(n)``. ``every_k`` > 1 accumulates that many
    micro-steps' gradients into their mean before each update
    (``optax.MultiSteps``)."""

    schedule: Callable[[int], float]
    weight_decay: float
    max_grad_norm: float
    b1: float
    b2: float
    eps: float = 1e-8
    every_k: int = 1

    def init(self, trainable: Dict[str, torch.Tensor]) -> OptState:
        adamw = torch.optim.AdamW(
            list(trainable.values()), lr=self.schedule(0), betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
        )
        acc = None
        if self.every_k > 1:
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                   for t in trainable.values()]
        return OptState(adamw, acc=acc)

    @torch.no_grad()
    def _apply(self, opt: OptState, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], grad_norm: torch.Tensor) -> None:
        if self.max_grad_norm:
            grads = [torch.where(grad_norm < self.max_grad_norm, g,
                                 g / grad_norm.to(g.dtype) * self.max_grad_norm) for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        for group in opt.adamw.param_groups:
            group["lr"] = self.schedule(opt.count)
        opt.adamw.step()
        for p in params:
            p.grad = None
        opt.count += 1

    @torch.no_grad()
    def update(self, opt: OptState, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """One micro-step: with every_k 1 an update of ``params`` in place
        from their (unclipped) grads, whose norm is ``grad_norm``; else the
        grads join the running mean (Welford, as optax's) and every k-th
        call updates from the mean and zeroes it."""
        if self.every_k == 1:
            self._apply(opt, params, grads, grad_norm)
            return
        n = opt.mini_step
        for a, g in zip(opt.acc, grads):
            a.add_((g.float() - a) / (n + 1))
        opt.mini_step = (n + 1) % self.every_k
        if opt.mini_step == 0:
            mean = [a.to(p.dtype) for a, p in zip(opt.acc, params)]
            self._apply(opt, params, mean, global_norm(mean, params))
            for a in opt.acc:
                a.zero_()


def multi_steps(optimizer: Optimizer, every_k: int) -> Optimizer:
    """``optimizer`` updating once every ``every_k`` calls, from the mean of
    their gradients (``optax.MultiSteps(optimizer, every_k)``)."""
    if every_k < 1:
        raise ValueError(f"every_k must be at least 1, got {every_k}")
    return dataclasses.replace(optimizer, every_k=every_k)


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


def global_norm(tensors: Iterable[torch.Tensor], like: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's), of
    the whole leaves: ``tensors`` are shaped as the leaves ``like`` holds,
    and fsdp shards' sums are added over their group."""
    return torch.sqrt(sq_sum(tensors, like))


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
    trainable = {k: carry_shard(v, v.detach().to(dev).clone().requires_grad_(True))
                 for k, v in trainable.items()}
    frozen = {k: carry_shard(v, v.detach().to(dev)) for k, v in frozen.items()}
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
    pipe_mesh: Optional[Mesh] = None,
    pipe_micro: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """The train step: (state, batch) -> (state, metrics), metrics ``loss``,
    ``grad_norm`` (this call's gradients, before clipping) and
    ``param_norm`` (after the update, if this call made one).
    ``batch`` holds tensors on the state's device: with ``mesh``, this
    process's rows of the global batch, and the metrics are the global
    batch's. ``pipe_mesh`` (the mesh, when it has pipeline stages) runs the
    decoder stack as a GPipe schedule of ``pipe_micro`` microbatches."""
    mesh = mesh if mesh is not None else pipe_mesh
    group = mesh.batch_group if mesh is not None else None
    pipe_group = _pipe_group(pipe_mesh)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = merge_params(params_template, state.trainable, state.frozen)
        loss = uv.ultravox_loss(params, cfg, batch, loss_config, remat=remat,
                                attn_impl=attn_impl, vocab_chunk=vocab_chunk,
                                pipe_mesh=pipe_mesh, pipe_micro=pipe_micro, batch_group=group)
        leaves = list(state.trainable.values())
        if pipe_group is None:
            grads = torch.autograd.grad(loss, leaves)
        elif loss.requires_grad:  # a stage's loss reaches only some leaves
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        else:
            grads = [torch.zeros_like(p) for p in leaves]
        if mesh is not None:
            grads = reduce_gradients(leaves, grads, mesh)
        grad_norm = global_norm(grads, leaves)
        optimizer.update(state.opt_state, leaves, grads, grad_norm)
        with torch.no_grad():
            param_norm = global_norm(leaves, leaves)
        loss = all_reduce_(all_reduce_(loss.detach().clone(), group), pipe_group)
        metrics = {"loss": loss, "grad_norm": grad_norm, "param_norm": param_norm}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_eval_step(
    cfg: UltravoxConfig,
    loss_config: LossConfig,
    params_template: Params,
    *,
    vocab_chunk: Optional[int] = None,
    attn_impl: str = "xla",
    pipe_mesh: Optional[Mesh] = None,
    pipe_micro: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Validation loss step: (state, batch) -> (nll sum, label count), for
    weighted averaging; ``vocab_chunk``, ``attn_impl``, ``pipe_mesh``,
    ``pipe_micro`` and ``mesh`` as in the train step (the sums are this
    process's, the last stage's on every stage; the caller adds them over
    the batch group)."""
    mesh = mesh if mesh is not None else pipe_mesh
    group = mesh.batch_group if mesh is not None else None
    pipe_group = _pipe_group(pipe_mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = merge_params(params_template, state.trainable, state.frozen)
        labels = batch["labels"]
        pipe = pipe_group is not None
        out = uv.ultravox_forward(params, cfg, batch, return_hidden=bool(vocab_chunk) or pipe,
                                  attn_impl=attn_impl, pipe_mesh=pipe_mesh,
                                  pipe_micro=pipe_micro, batch_group=group)
        lm = params["language_model"]
        if not uv.computes_loss(pipe_mesh):
            s, c = out.new_zeros((), dtype=torch.float32), labels.new_zeros(())
        elif vocab_chunk:
            s, c = uv.chunked_nll_sums(lm, cfg.text_config, out, labels, chunk=vocab_chunk)
        else:
            if pipe:
                out = uv.decoder_lib.compute_logits(lm, cfg.text_config, out)
            s, c = _dense_nll_sums(out, labels)
        if not pipe:
            return s, c
        sums = all_reduce_(torch.stack([s.double(), c.double()]), pipe_group)
        return sums[0].float(), sums[1].long()

    return eval_step


def _pipe_group(pipe_mesh: Optional[Mesh]):
    """The pipe group of a mesh with pipeline stages, else None."""
    return pipe_mesh.groups["pipe"] if pipe_mesh is not None and pipe_mesh.n_stages > 1 else None


def _dense_nll_sums(logits, labels):
    """(nll sum, label count) of fp32 logits (B, T, V)."""
    shift = labels[:, 1:]
    valid = shift != -100
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, shift, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()
