"""Parameter sharding rules: regex path -> spec, and the fsdp gathers and
reductions the JAX package leaves to XLA.

Every parameter leaf gets a spec from a rules table keyed on its tree path
(a tuple with one entry per dim: a mesh axis name or None), as the JAX
package's ``parallel/sharding.py`` does. There XLA inserts the
collectives; here they are written out:

- ``shard_params`` keeps, on each process, only its 1/fsdp slice of every
  leaf whose spec names ``fsdp``, tagged with how it was cut (``Shard``);
  ``data`` and axes of size 1 replicate;
- the models take each sharded leaf whole through ``gather`` (or
  ``gather_layer`` for one layer of a stacked leaf) just before its use:
  an all-gather over the fsdp group, differentiable for a trainable leaf
  (its backward reduce-scatters the gradient);
- ``reduce_gradients`` sums each gradient over the processes that hold
  the same leaf, and ``sq_sum`` counts every element of a sharded tree
  once, so the global norm is the full gradient's.

Paths look like "language_model/layers/q_proj/kernel"; layer-stacked
leaves have a leading L axis, which is never sharded (it is looped over).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ultravox_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)

Spec = Tuple[Optional[str], ...]

# (path regex, spec). First match wins.
DEFAULT_RULES: List[Tuple[str, Spec]] = [
    # ---- decoder LLM ----
    (r".*language_model/embed_tokens$", ("tensor", "fsdp")),
    (r".*language_model/layers/(q|k|v)_proj/kernel$", (None, "fsdp", "tensor")),
    (r".*language_model/layers/(q|k|v)_proj/bias$", (None, "tensor")),
    (r".*language_model/layers/o_proj/kernel$", (None, "tensor", "fsdp")),
    (r".*language_model/layers/(gate|up)_proj/kernel$", (None, "fsdp", "tensor")),
    (r".*language_model/layers/down_proj/kernel$", (None, "tensor", "fsdp")),
    (r".*language_model/lm_head/kernel$", ("fsdp", "tensor")),
    # ---- audio encoder ----
    (r".*audio_tower/layers/(q|k|v)_proj/kernel$", (None, "fsdp", "tensor")),
    (r".*audio_tower/layers/out_proj/kernel$", (None, "tensor", "fsdp")),
    (r".*audio_tower/layers/fc1/kernel$", (None, "fsdp", "tensor")),
    (r".*audio_tower/layers/fc1/bias$", (None, "tensor")),
    (r".*audio_tower/layers/fc2/kernel$", (None, "tensor", "fsdp")),
    (r".*audio_tower/embed_positions$", (None, "fsdp")),
    # ---- projector ----
    (r".*projector/linear_1/kernel$", ("fsdp", "tensor")),
    (r".*projector/linear_2/kernel$", ("tensor", "fsdp")),
    # ---- everything else (norms, convs, biases) replicated ----
    (r".*", ()),
]


def rules_for_mesh(mesh: Mesh) -> List[Tuple[str, Spec]]:
    """DEFAULT_RULES, with the decoder layer stack's leading L axis over
    ``pipe`` when the mesh carries pipeline stages (each stage holds only
    its own layers). ``make_mesh`` refuses such a mesh until the GPipe
    schedule is ported (ROADMAP.md queue A item 7b); the table is kept."""
    if mesh.shape.get("pipe", 1) <= 1:
        return DEFAULT_RULES
    out: List[Tuple[str, Spec]] = []
    for pat, spec in DEFAULT_RULES:
        if "language_model/layers/" in pat:
            spec = ("pipe",) + tuple(spec)[1:]
        out.append((pat, spec))
    # layer-stacked leaves not named above also carry the leading L axis
    out.insert(len(out) - 1, (r".*language_model/layers/.*", ("pipe",)))
    return out


# --------------------------------------------------------------------------
# the parameter tree's paths, in the JAX package's flattening order
# --------------------------------------------------------------------------


def _children(node):
    """(key, child) pairs of a dict (sorted keys) or a list (index order),
    the JAX package's flattening order; None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, list):  # the wav2vec2 conv stack (a template leaf is a tuple)
        return list(enumerate(node))
    return None


def path_items(tree: Any, prefix: str = ""):
    """(path, leaf) pairs in the JAX package's flattening order, paths
    joined with "/" and a list index written as its number, as the JAX
    package's ``_path_str`` names them ("audio_tower/feature_extractor/0/kernel")."""
    for k, v in _children(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if _children(v) is None:
            yield path, v
        else:
            yield from path_items(v, path)


def map_paths(fn, tree: Any, prefix: str = "") -> Any:
    """The tree with each leaf replaced by fn(path, leaf)."""
    def one(k, v):
        path = f"{prefix}/{k}" if prefix else str(k)
        return fn(path, v) if _children(v) is None else map_paths(fn, v, path)

    if isinstance(tree, dict):
        return {k: one(k, v) for k, v in tree.items()}
    return [one(i, v) for i, v in enumerate(tree)]


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------


def spec_for_path(path_str: str, rules: Sequence[Tuple[str, Spec]]) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path_str):
            return spec
    return ()


def _shrink_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh, path: str = "") -> Spec:
    """Drop mesh axes that don't divide the corresponding dim (tiny test
    models, odd vocab sizes): the leaf is then replicated on that axis,
    which on a large model burns memory on every device, so it warns
    loudly (once per leaf) when a dim of 1024 or more loses its sharding."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None:
            out.append(None)
            continue
        size = mesh.shape[axis] if isinstance(axis, str) else math.prod(
            mesh.shape[a] for a in axis)
        if i < len(shape) and shape[i] % size == 0:
            out.append(axis)
        else:
            out.append(None)
            if size > 1 and i < len(shape) and shape[i] >= 1024:
                logger.warning(
                    "sharding rule dropped: %s dim %d (size %d) is not divisible by mesh "
                    "axis %r (size %d) — parameter will be REPLICATED on that axis, costing "
                    "memory on every device", path or "<param>", i, shape[i], axis, size)
    return tuple(out)


def param_pspecs(params: Any, rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES,
                 mesh: Optional[Mesh] = None) -> Any:
    """The spec tree matching ``params`` (whole leaves)."""

    def leaf_spec(path, leaf):
        spec = spec_for_path(path, rules)
        if mesh is not None:
            spec = _shrink_spec(spec, tuple(leaf.shape), mesh, path)
        return spec

    return map_paths(leaf_spec, params)


# --------------------------------------------------------------------------
# fsdp shards
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """How a leaf is cut over the fsdp axis: this process holds chunk
    ``index`` of ``size`` along ``dim`` of the whole ``full_shape``."""

    dim: int
    full_shape: Tuple[int, ...]
    size: int
    index: int
    group: Any


_ATTR = "_fsdp_shard"


def shard_of(t) -> Optional[Shard]:
    """The leaf's Shard, None for a whole leaf."""
    return getattr(t, _ATTR, None)


def carry_shard(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst`` (a copy of ``src``, moved or detached) tagged as ``src`` is."""
    s = shard_of(src)
    if s is not None:
        setattr(dst, _ATTR, s)
    return dst


def full_shape(t: torch.Tensor) -> Tuple[int, ...]:
    s = shard_of(t)
    return tuple(t.shape) if s is None else s.full_shape


def local_slice(full: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This process's chunk of a whole leaf, in storage of its own, tagged."""
    out = full.chunk(shard.size, shard.dim)[shard.index].clone(
        memory_format=torch.contiguous_format)
    setattr(out, _ATTR, shard)
    return out


def shard_params(params: Any, mesh: Mesh, rules: Optional[Sequence[Tuple[str, Spec]]] = None
                 ) -> Any:
    """The tree with every leaf whose spec names ``fsdp`` cut to this
    process's 1/fsdp slice (default rules: ``rules_for_mesh``). Other
    leaves are the caller's tensors, untouched."""
    if rules is None:
        rules = rules_for_mesh(mesh)
    size = mesh.shape["fsdp"]
    if size == 1:
        return params

    def place(path, leaf):
        spec = _shrink_spec(spec_for_path(path, rules), tuple(leaf.shape), mesh, path)
        if "fsdp" not in spec:
            return leaf
        shard = Shard(spec.index("fsdp"), tuple(leaf.shape), size, mesh.coords["fsdp"],
                      mesh.groups["fsdp"])
        return local_slice(leaf.detach(), shard)

    return map_paths(place, params)


def _all_gather(local: torch.Tensor, dim: int, s: Shard) -> torch.Tensor:
    x = local.movedim(dim, 0).contiguous()
    out = x.new_empty((s.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=s.group)
    return out.movedim(0, dim)


def _reduce_scatter(full: torch.Tensor, dim: int, s: Shard) -> torch.Tensor:
    x = full.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // s.size, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=s.group)
    return out.movedim(0, dim)


class _GatherShards(torch.autograd.Function):
    """All-gather forward, reduce-scatter (sum) backward: a trainable
    leaf's gradient lands on its shard summed over the fsdp group."""

    @staticmethod
    def forward(ctx, local, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _all_gather(local, dim, shard)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.shard), None, None


def _gather(local: torch.Tensor, dim: int, s: Shard) -> torch.Tensor:
    if local.requires_grad and torch.is_grad_enabled():
        return _GatherShards.apply(local, dim, s)
    return _all_gather(local, dim, s)


def gather(t):
    """The whole leaf: ``t`` itself unless it is an fsdp shard."""
    s = shard_of(t)
    return t if s is None else _gather(t, s.dim, s)


def gather_layer(t, l: int):
    """Layer ``l`` of a leaf stacked on its leading L axis, whole."""
    s = shard_of(t)
    return t[l] if s is None else _gather(t[l], s.dim - 1, s)


def gather_as(t: torch.Tensor, like) -> torch.Tensor:
    """``t``, shaped as the leaf ``like`` is held (its optimizer moments,
    its gradient buffer), whole: a shard's is gathered, without autograd."""
    s = shard_of(like)
    return t if s is None else _all_gather(t.detach(), s.dim, s)


def gather_tree(tree: Any) -> Any:
    """Every leaf whole (every process of the fsdp group must call it)."""
    return map_paths(lambda _, leaf: gather(leaf).detach() if shard_of(leaf) else leaf, tree)


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``; nothing without one."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def reduce_gradients(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     mesh: Mesh) -> List[torch.Tensor]:
    """Each gradient summed over the processes that hold the same leaf: a
    shard's (already summed over fsdp by its gather's backward) over
    ``data``, a whole leaf's over the batch axes. One all-reduce per group
    and dtype, on a flat buffer."""
    out = list(grads)
    buckets: List[Tuple[Any, torch.dtype, List[int]]] = []
    for i, (p, g) in enumerate(zip(params, grads)):
        group = mesh.groups["data"] if shard_of(p) is not None else mesh.batch_group
        if group is None:
            continue
        for b in buckets:
            if b[0] is group and b[1] == g.dtype:
                b[2].append(i)
                break
        else:
            buckets.append((group, g.dtype, [i]))
    for group, _, idx in buckets:
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    return out


def sq_sum(tensors: Iterable[torch.Tensor], like: Sequence[torch.Tensor]) -> torch.Tensor:
    """fp32 sum of squares of every element of the whole leaves, from
    ``tensors`` shaped as the leaves ``like`` hold them: a whole leaf
    counts once, the shards' sums are added over the fsdp group."""
    whole, parts, group = [], [], None
    for t, p in zip(tensors, like):
        sq = (t.float() * t.float()).sum()
        s = shard_of(p)
        if s is None:
            whole.append(sq)
        else:
            parts.append(sq)
            group = s.group
    total = sum(whole)
    if parts:
        total = total + all_reduce_(sum(parts), group)
    return total
