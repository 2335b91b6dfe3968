"""Pipeline parallelism (GPipe) over the decoder layer stack: the ``pipe``
axis of the mesh.

Each stage holds L / P contiguous decoder layers (``sharding.StageSlice``,
cut by ``shard_params``) and is one process. Microbatches stream through
the stages by point-to-point sends. Schedule (classic GPipe): T = M + P - 1
steps for M microbatches over P stages; at step t stage s runs microbatch
t - s, and every step posts its receive and the previous step's send
together and waits on both (``_hop``). The bubble is (P-1)/(M+P-1).

The JAX package runs the schedule inside ``shard_map`` and lets
reverse-mode AD derive the backward (the transpose of a ``ppermute`` is the
reverse hop). Here the backward schedule is written out, so nothing is left
to the autograd engine's order between ranks: one ``autograd.Function``
over the whole stage stack (``_Stages``) runs the forward schedule and
keeps each microbatch's stage input and graph (each layer checkpointed
under ``remat``, as ``decoder_forward`` does), and its backward walks the
microbatches in reverse order: receive dh from the next stage, backprop
through this stage's layers (an fsdp gather's backward reduce-scatters
there, on every fsdp peer of the stage alike), send dx to the previous
stage.

Over gloo a CUDA tensor crosses each hop through a pinned host buffer
(gloo's point-to-point reads and writes host memory); NCCL sends it from
the card. A hop that fails raises on the rank that waits for it.

Where the port differs from the JAX package, and why:

- The output is the last stage's alone (the JAX package replicates it to
  every stage by ``psum`` and computes the loss on all of them): other
  stages get zeros of its shape, tied to the graph, so that a loss that
  takes them (times zero) still runs their backward schedule. The loss
  runs on the last stage (``models/ultravox.py``), and the leaves every
  stage holds are summed over ``pipe`` (``sharding.reduce_gradients``).
- Every stage computes the stack's input (the caller passes it on each
  stage; only stage 0's values enter the pipeline, and the other stages
  get a zero gradient for theirs). So the stages make the same
  collectives before the pipeline and reach the same trainable leaves.
- The rope tables and attention biases are built once on every stage and
  indexed by microbatch, not sent along: every stage holds the same rows.
- Microbatches: JAX's count applies to the global batch (this process's
  rows times the batch shards), with its ``ValueError``; a process splits
  its own rows into the largest count that divides them and is at most
  that. Rows are independent in the decoder, so the values do not depend
  on the count.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ultravox_torch.models.remat import remat as checkpoint_remat
from ultravox_torch.ops.attention import mha
from ultravox_torch.ops.norms import rms_norm
from ultravox_torch.ops.rope import rope_cos_sin
from ultravox_torch.parallel.mesh import Mesh
from ultravox_torch.parallel.sharding import carry_shard, map_paths, path_items


def _first_layer(mesh: Mesh, n_local: int) -> int:
    """The global index of this stage's first layer."""
    return mesh.stage * n_local


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` crosses a hop through host memory (gloo on the card)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _hop(send: Optional[torch.Tensor], dst: Optional[int], recv_like: Optional[torch.Tensor],
         src: Optional[int]) -> Optional[torch.Tensor]:
    """One step's hops, posted together and waited on: ``send`` to rank
    ``dst`` and a tensor shaped as ``recv_like`` from rank ``src`` (each
    only where given). Returns the received tensor on ``recv_like``'s
    device."""
    works, buf = [], None
    if send is not None:
        payload = send.contiguous()
        if _staged(payload):
            payload = torch.empty(payload.shape, dtype=payload.dtype,
                                  pin_memory=True).copy_(payload)
        works.append(dist.isend(payload, dst))
    if recv_like is not None:
        staged = _staged(recv_like)
        buf = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                          device="cpu" if staged else recv_like.device, pin_memory=staged)
        works.append(dist.irecv(buf, src))
    for work in works:
        work.wait()
    return None if buf is None else buf.to(recv_like.device)


def default_n_micro(batch: int, n_stages: int) -> int:
    """The JAX package's microbatch count: the largest of 4P, 3P and 2P
    that divides ``batch``, else P."""
    for m in (4 * n_stages, 3 * n_stages, 2 * n_stages):
        if batch % m == 0:
            return m
    return n_stages


class _Schedule:
    """The stage's half of one pipelined call: its layers, the microbatch
    contexts, and what the forward keeps for the backward."""

    def __init__(self, layer_fn, stacked_local, acts: Dict[str, torch.Tensor], n_micro: int,
                 remat: bool, mesh: Mesh):
        self.layer_fn, self.stacked, self.acts = layer_fn, stacked_local, acts
        self.M, self.remat, self.mesh = n_micro, remat, mesh
        self.n_local = next(iter(path_items(stacked_local)))[1].shape[0]

    def _run(self, layers, m: int, h: torch.Tensor) -> torch.Tensor:
        """Microbatch ``m``'s activations ``h`` through this stage's layers."""
        act = {k: v[m] for k, v in self.acts.items() if k != "h"}
        for l in range(self.n_local):
            def one(h_, l=l):
                return self.layer_fn(layers, l, {**act, "h": h_})["h"]

            h = checkpoint_remat(one, h) if self.remat else one(h)
        return h

    def forward(self, x: torch.Tensor, leaves: List[torch.Tensor], keep_graph: bool):
        """The forward schedule on microbatches ``x`` (M, b, ...): the last
        stage's outputs (M, b, ...), zeros on the other stages. With
        ``keep_graph`` each microbatch's stage input and output are kept,
        computed on copies of the leaves that the backward differentiates."""
        mesh, M = self.mesh, self.M
        P, s = mesh.n_stages, mesh.stage
        last = s == P - 1
        layers = self.stacked
        if keep_graph:
            self.copies = [carry_shard(p, p.detach().requires_grad_(p.requires_grad))
                           for p in leaves]
            by_path = dict(zip((path for path, _ in path_items(self.stacked)), self.copies))
            layers = map_paths(lambda path, _: by_path[path], self.stacked)
            self.x_grad = x.requires_grad
            self.inputs: List[Optional[torch.Tensor]] = [None] * M
            self.outputs: List[Optional[torch.Tensor]] = [None] * M
        outs = torch.zeros_like(x)
        sent = None
        for t in range(M + P - 1):
            m = t - s
            now = 0 <= m < M
            h = _hop(sent, mesh.next_stage_rank, x[0] if now and s > 0 else None,
                     mesh.prev_stage_rank)
            sent = None
            if not now:
                continue
            h = x[m] if s == 0 else h
            if keep_graph:
                h = h.detach().requires_grad_(s > 0 or self.x_grad)
                with torch.enable_grad():
                    out = self._run(layers, m, h)
                self.inputs[m], self.outputs[m] = h, out
            else:
                out = self._run(layers, m, h)
            if last:
                outs[m] = out.detach()
            else:
                sent = out.detach()
        return outs

    def backward(self, grad_out: torch.Tensor):
        """The reverse schedule: (dx, grads of the leaves)."""
        mesh, M = self.mesh, self.M
        P, s = mesh.n_stages, mesh.stage
        last = s == P - 1
        want = [c for c in self.copies if c.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(want)
        dx = torch.zeros_like(grad_out) if self.x_grad else None
        sent = None
        for t in range(M + P - 1):
            m = M - 1 - (t - (P - 1 - s))
            now = 0 <= m < M
            dh = _hop(sent, mesh.prev_stage_rank, grad_out[0] if now and not last else None,
                      mesh.next_stage_rank)
            sent = None
            if not now:
                continue
            dh = grad_out[m] if last else dh
            h_in = self.inputs[m]
            inputs = ([h_in] if h_in.requires_grad else []) + want
            grads = torch.autograd.grad(self.outputs[m], inputs, dh, allow_unused=True)
            self.inputs[m] = self.outputs[m] = None
            if h_in.requires_grad:
                d_in, grads = grads[0], grads[1:]
                if s > 0:
                    sent = d_in
                else:
                    dx[m] = d_in
            for i, g in enumerate(grads):
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i] + g
        it = iter(acc)
        out = []
        for c in self.copies:
            g = next(it) if c.requires_grad else None
            out.append(torch.zeros_like(c) if c.requires_grad and g is None else g)
        return dx, out  # dx: zero on the other stages, whose input never fed the pipeline


class _Stages(torch.autograd.Function):
    """The stage stack as one differentiable call: forward and backward
    schedules of ``_Schedule``."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        ctx.sched = sched
        return sched.forward(x, list(leaves), keep_graph=True)

    @staticmethod
    def backward(ctx, grad_out):
        dx, grads = ctx.sched.backward(grad_out.contiguous())
        ctx.sched = None
        return (None, dx, *grads)


def pipeline_layers(
    layer_fn: Callable[[Any, int, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
    stacked_local: Any,
    acts: Dict[str, torch.Tensor],
    *,
    n_micro: int,
    n_stages: int,
    remat: bool = False,
    mesh: Mesh,
) -> Dict[str, torch.Tensor]:
    """Run every microbatch through all layers of the pipeline over
    ``mesh``'s ``pipe`` axis (``n_stages`` stages, this process one).

    ``layer_fn(stacked, l, act) -> act`` applies this stage's layer ``l``
    (gathering its fsdp shards inside, so a recompute under ``remat``
    gathers again); ``stacked_local`` is this stage's layer slice (leading
    axis num_layers / n_stages); ``acts`` is the microbatch stack (leading
    axis ``n_micro`` on every leaf): "h", the activations, plus any
    per-microbatch context (rope tables, attention biases), which every
    stage holds and indexes by microbatch.

    Returns ``acts`` with "h" after all layers on the last stage and zeros
    on the others. Differentiable in "h" (stage 0's) and in the leaves of
    ``stacked_local`` that require grad; every stage must make the call."""
    if n_stages != mesh.n_stages:
        raise ValueError(f"n_stages {n_stages} but the mesh has {mesh.n_stages} pipeline stages")
    x = acts["h"]
    if x.shape[0] != n_micro:
        raise ValueError(f"acts carry {x.shape[0]} microbatches, n_micro is {n_micro}")
    sched = _Schedule(layer_fn, stacked_local, acts, n_micro, remat, mesh)
    leaves = [leaf for _, leaf in path_items(stacked_local)]
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in leaves)):
        out = _Stages.apply(sched, x, *leaves)
    else:
        out = sched.forward(x, leaves, keep_graph=False)
    return {**acts, "h": out}


def pipelined_decoder_hidden(
    params: Any,
    cfg,
    inputs_embeds: torch.Tensor,  # (B, T, D)
    positions: torch.Tensor,  # (B, T)
    kv_valid_len: torch.Tensor,  # (B,)
    *,
    mesh: Mesh,
    n_micro: Optional[int] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Cache-less (training) decoder forward with the layer stack
    pipelined over ``mesh``'s ``pipe`` axis: the pipeline-parallel
    counterpart of ``decoder_forward(..., return_hidden=True)``. Every
    stage calls it with the same batch; the final hidden states (B, T, D),
    after the final RMSNorm, are the last stage's, zeros elsewhere.

    ``cfg.num_layers`` must divide by the stage count and the global batch
    (B times the mesh's batch shards) by ``n_micro``, by default the
    largest of 4P, 3P and 2P that divides it, else P. Each layer runs as
    the JAX package's pipelined layer: plain attention, its window, local
    rope base and bias chosen by its global index."""
    from ultravox_torch.models import decoder as dl  # the decoder imports parallel/

    n_stages = mesh.n_stages
    if cfg.num_layers % n_stages:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by {n_stages} "
                         f"pipeline stages")
    B, T = inputs_embeds.shape[:2]
    batch = B * mesh.batch_shards
    M = default_n_micro(batch, n_stages) if n_micro is None else n_micro
    if batch % M:
        raise ValueError(f"batch {batch} not divisible by n_micro={M}")
    m_local = max(m for m in range(1, min(M, B) + 1) if B % m == 0)

    x = dl._scale_embeddings(cfg, inputs_embeds)
    bias_g, bias_l = dl.make_attention_bias(cfg, positions, T, kv_valid_len)
    inv_g, inv_l = dl._inv_freqs(cfg, x.device)
    cos_g, sin_g = rope_cos_sin(positions, inv_g)
    cos_l, sin_l = rope_cos_sin(positions, inv_l) if inv_l is not inv_g else (cos_g, sin_g)

    def split(a):
        return a.reshape((m_local, B // m_local) + tuple(a.shape[1:]))

    acts = {"h": split(x), "cos_g": split(cos_g), "sin_g": split(sin_g),
            "cos_l": split(cos_l), "sin_l": split(sin_l), "bias_g": split(bias_g)}
    if bias_l is not None:
        acts["bias_l"] = split(bias_l)
    local = dl.is_local_layer(cfg)
    first = _first_layer(mesh, cfg.num_layers // n_stages)

    def layer_fn(layers, l, act):
        loc = bool(local[first + l])
        bias = act["bias_l"] if (loc and "bias_l" in act) else act["bias_g"]
        cos, sin = (act["cos_l"], act["sin_l"]) if loc else (act["cos_g"], act["sin_g"])

        def attend(q, k, v):
            return mha(q, k, v, bias=bias, scale=cfg.attn_scale,
                       softcap=cfg.attn_logit_softcapping)

        return {**act, "h": dl._gathered_layer_forward(cfg, act["h"], layers, l, cos, sin,
                                                       attend)}

    out = pipeline_layers(layer_fn, params["layers"], acts, n_micro=m_local,
                          n_stages=n_stages, remat=remat, mesh=mesh)
    h = out["h"].reshape((B,) + tuple(out["h"].shape[2:]))
    if mesh.stage != n_stages - 1:
        return h
    return rms_norm(h, params["norm"], cfg.rms_norm_eps, plus_one=dl._plus_one(cfg))
