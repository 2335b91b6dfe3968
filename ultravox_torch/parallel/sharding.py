"""Parameter sharding rules: regex path -> spec, and the collectives the
JAX package leaves to XLA.

Every parameter leaf gets a spec from a rules table keyed on its tree path
(a tuple with one entry per dim: a mesh axis name or None), as the JAX
package's ``parallel/sharding.py`` does. There XLA inserts the
collectives; here they are written out:

- ``shard_params`` cuts, on each process, a decoder layer leaf to its
  stage's L/pipe layers when the mesh has pipeline stages
  (``StageSlice``), then a leaf whose spec names ``tensor`` to this rank's
  slice (``TensorSplit``), on head boundaries for the attention leaves,
  then a leaf whose spec names ``fsdp`` to its 1/fsdp slice (``Shard``);
  ``data`` and axes of size 1 replicate. Where ``tensor`` does not divide
  the KV heads but the KV heads divide it, a rank keeps the whole K/V
  projections and reads the heads its query heads read (a
  ``TensorSplit`` with ``cols``);
- the models take each fsdp shard whole through ``gather`` (or
  ``gather_layer`` for one layer of a stacked leaf) just before its use:
  an all-gather over the fsdp group, differentiable for a trainable leaf
  (its backward reduce-scatters the gradient). A tensor split stays split
  inside a layer (Megatron): ``to_tensor`` (identity forward, all-reduce
  backward) enters a column-split product, ``from_tensor`` (all-reduce
  forward, identity backward) leaves a row-split one. The vocabulary
  leaves (``VOCAB_LEAVES``: the embedding and the head) stay split too:
  ``vocab_lookup`` reads this rank's rows and one all-reduce adds the
  ranks' parts, the head gives this rank's slice of the logits, which the
  losses use as they are (``models/ultravox.py``) and a sampler takes
  whole through ``gather_logits``. The projector is gathered over
  ``tensor`` (``gather_whole``, whose backward keeps this rank's slice of
  a gradient every tensor peer computes alike). A stage slice is never
  gathered in a step: each stage runs its own layers (``pipeline.py``);
- ``reduce_gradients`` sums each gradient over the processes that hold
  the same leaf and split the batch (never over ``tensor``: a split
  leaf's peers hold other slices, a whole leaf's the same gradient), and a
  leaf every stage holds whole over ``pipe`` too (each stage's part of
  its gradient, zero where the stage did not use it); a stage slice's
  never. ``sq_sum`` counts every element of a sharded tree once, so the
  global norm is the full gradient's.

Paths look like "language_model/layers/q_proj/kernel"; layer-stacked
leaves have a leading L axis, which only ``pipe`` cuts (a stage loops over
its own layers).
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
# the leaves whose vocabulary dim the rules split over ``tensor``
VOCAB_LEAVES = r"(.*/)?language_model/(embed_tokens|lm_head/kernel)"


def rules_for_mesh(mesh: Mesh) -> List[Tuple[str, Spec]]:
    """DEFAULT_RULES, with the decoder layer stack's leading L axis over
    ``pipe`` when the mesh carries pipeline stages: each stage holds only
    its own layers (``shard_params``, ``StageSlice``), which
    ``pipeline.py`` runs."""
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
# placements: the tensor split, then the fsdp shard
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """How a leaf is cut over the fsdp axis: this process holds chunk
    ``index`` of ``size`` along ``dim`` of ``full_shape``, the leaf as the
    tensor axis left it (the whole leaf without a tensor split)."""

    dim: int
    full_shape: Tuple[int, ...]
    size: int
    index: int
    group: Any


@dataclasses.dataclass(frozen=True, eq=False)
class TensorSplit:
    """How a leaf sits on the tensor axis. With ``dim`` (negative, so a
    layer of a stacked leaf keeps it), this process holds chunk ``index``
    of ``size`` along it of the whole ``full_shape``. With ``dim`` None it
    holds the whole leaf and reads its last-axis elements ``cols`` (the
    K/V heads its query heads read)."""

    dim: Optional[int]
    full_shape: Tuple[int, ...]
    size: int
    index: int
    group: Any
    cols: Optional[Tuple[int, int]] = None


@dataclasses.dataclass(frozen=True, eq=False)
class StageSlice:
    """How a decoder layer leaf sits on the pipe axis: this process holds
    layers ``offset`` to ``offset + L / size`` of the ``layers`` (L) on its
    leading axis, stage ``index`` of ``size``."""

    offset: int
    layers: int
    size: int
    index: int
    group: Any


_ATTR = "_fsdp_shard"
_TP_ATTR = "_tensor_split"
_PP_ATTR = "_stage_slice"


def shard_of(t) -> Optional[Shard]:
    """The leaf's fsdp Shard, None for a leaf whole over fsdp."""
    return getattr(t, _ATTR, None)


def split_of(t) -> Optional[TensorSplit]:
    """The leaf's TensorSplit, None for a leaf the tensor axis leaves alone."""
    return getattr(t, _TP_ATTR, None)


def stage_of(t) -> Optional[StageSlice]:
    """The leaf's StageSlice, None for a leaf every stage holds whole."""
    return getattr(t, _PP_ATTR, None)


def _cut_over_tensor(t) -> Optional[TensorSplit]:
    sp = split_of(t)
    return sp if sp is not None and sp.dim is not None else None


def is_placed(t) -> bool:
    """Whether this process holds only a part of the leaf."""
    return (shard_of(t) is not None or _cut_over_tensor(t) is not None
            or stage_of(t) is not None)


def _tag(t: torch.Tensor, shard: Optional[Shard], split: Optional[TensorSplit],
         stage: Optional[StageSlice] = None) -> torch.Tensor:
    if shard is not None:
        setattr(t, _ATTR, shard)
    if split is not None:
        setattr(t, _TP_ATTR, split)
    if stage is not None:
        setattr(t, _PP_ATTR, stage)
    return t


def carry_shard(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst`` (a copy of ``src``, moved or detached) tagged as ``src`` is."""
    return _tag(dst, shard_of(src), split_of(src), stage_of(src))


def full_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The whole leaf's shape."""
    sp, s, st = _cut_over_tensor(t), shard_of(t), stage_of(t)
    shape = sp.full_shape if sp is not None else tuple(t.shape) if s is None else s.full_shape
    return shape if st is None else (st.layers,) + shape[1:]


def _chunk(t: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    return t.chunk(size, dim)[index]


def cut_as(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This process's part of a whole tensor, cut as the leaf ``like`` is,
    in storage of its own and tagged; ``whole`` itself where ``like`` is
    whole or ``whole`` has another shape (an optimizer's step count)."""
    if not is_placed(like) or tuple(whole.shape) != full_shape(like):
        return whole
    sp, s, st = _cut_over_tensor(like), shard_of(like), stage_of(like)
    out = whole if st is None else _chunk(whole, 0, st.size, st.index)
    if sp is not None:
        out = _chunk(out, sp.dim, sp.size, sp.index)
    if s is not None:
        out = _chunk(out, s.dim, s.size, s.index)
    return _tag(out.clone(memory_format=torch.contiguous_format), s, split_of(like), st)


def local_kv_heads(num_kv_heads: int, tensor: int) -> int:
    """The KV heads a tensor rank holds: its 1/tensor share, or the one
    head its query heads read where ``tensor`` is a multiple of them."""
    if num_kv_heads % tensor == 0:
        return num_kv_heads // tensor
    if tensor % num_kv_heads == 0:
        return 1
    raise ValueError(f"tensor {tensor} neither divides nor is a multiple of the "
                     f"{num_kv_heads} KV heads")


def _head_leaves(cfg) -> List[Tuple[str, int, int, bool]]:
    """(path regex, heads, head_dim, kv) of the leaves whose tensor dim
    runs over attention heads: the tensor axis cuts them between heads."""
    tc = cfg.text_config
    out = [(r".*language_model/layers/(q_proj/(kernel|bias)|o_proj/kernel)$",
            tc.num_heads, tc.head_dim, False),
           (r".*language_model/layers/(k|v)_proj/(kernel|bias)$",
            tc.num_kv_heads, tc.head_dim, True)]
    ac = getattr(cfg, "audio_config", None)
    if ac is not None and getattr(cfg, "audio_arch", "whisper") != "wav2vec2":
        out.append((r".*audio_tower/layers/((q|k|v)_proj|out_proj)/kernel$",
                    ac.num_heads, ac.head_dim, False))
    return out


def _tensor_split(path: str, leaf, dim: int, mesh: Mesh, cfg) -> Optional[TensorSplit]:
    """The tensor placement of a leaf whose (shrunk) spec names ``tensor``
    at ``dim``: cut on head boundaries for the attention leaves; None
    leaves it whole (a wav2vec2 tower runs whole on every rank)."""
    t, r, group = mesh.shape["tensor"], mesh.coords["tensor"], mesh.groups["tensor"]
    shape = tuple(leaf.shape)
    if path.startswith("audio_tower/") and getattr(cfg, "audio_arch", "whisper") == "wav2vec2":
        return None
    for pattern, heads, head_dim, kv in _head_leaves(cfg):
        if not re.fullmatch(pattern, path):
            continue
        if heads % t == 0:
            break
        if kv and t % heads == 0:
            h = r // (t // heads)
            return TensorSplit(None, shape, t, r, group, cols=(h * head_dim, (h + 1) * head_dim))
        raise ValueError(f"tensor {t} must divide the {heads} attention heads of {path}")
    return TensorSplit(dim, shape, t, r, group)


def shard_params(params: Any, mesh: Mesh, rules: Optional[Sequence[Tuple[str, Spec]]] = None,
                 cfg=None) -> Any:
    """The tree with every decoder layer leaf cut to this stage's layers
    (a spec that starts with ``pipe``), then every leaf whose spec names
    ``tensor`` cut to this rank's tensor slice and then every leaf whose
    spec names ``fsdp`` cut to its 1/fsdp slice (default rules:
    ``rules_for_mesh``). A tensor axis needs the model's
    ``UltravoxConfig`` (``cfg``) to cut on head boundaries. Leaves left
    whole are the caller's tensors, untouched."""
    if rules is None:
        rules = rules_for_mesh(mesh)
    t, f, pp = mesh.shape["tensor"], mesh.shape["fsdp"], mesh.shape["pipe"]
    if t == 1 and f == 1 and pp == 1:
        return params
    if t > 1 and cfg is None:
        raise ValueError("a tensor axis cuts on head boundaries: shard_params needs the "
                         "model's config (cfg=)")

    def place(path, leaf):
        spec = _shrink_spec(spec_for_path(path, rules), tuple(leaf.shape), mesh, path)
        split = shard = stage = None
        out = leaf.detach()
        if pp > 1 and spec[:1] == ("pipe",):
            n = leaf.shape[0] // pp
            stage = StageSlice(mesh.stage * n, leaf.shape[0], pp, mesh.stage, mesh.groups["pipe"])
            out = _chunk(out, 0, pp, stage.index)
        if t > 1 and "tensor" in spec:
            split = _tensor_split(path, out, spec.index("tensor") - leaf.dim(), mesh, cfg)
            if split is not None and split.dim is not None:
                out = _chunk(out, split.dim, t, split.index)
        if f > 1 and "fsdp" in spec:
            shard = Shard(spec.index("fsdp"), tuple(out.shape), f, mesh.coords["fsdp"],
                          mesh.groups["fsdp"])
            out = _chunk(out, shard.dim, f, shard.index)
        if split is None and shard is None and stage is None:
            return leaf
        if shard is not None or stage is not None or split.dim is not None:
            out = out.clone(memory_format=torch.contiguous_format)
        return _tag(out, shard, split, stage)  # a kept leaf: a tagged view of the caller's

    return map_paths(place, params)


# --------------------------------------------------------------------------
# gathers
# --------------------------------------------------------------------------


def _all_gather(local: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    x = local.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
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
        return _all_gather(local, dim, shard.size, shard.group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.shard), None, None


class _GatherSplit(torch.autograd.Function):
    """All-gather over ``tensor`` forward; backward keeps this rank's slice
    of the gradient, which every tensor peer computes alike (the leaf or
    the logits are used whole, on the same rows, on each of them)."""

    @staticmethod
    def forward(ctx, local, split):
        ctx.split = split
        return _all_gather(local, split.dim, split.size, split.group)

    @staticmethod
    def backward(ctx, grad):
        sp = ctx.split
        return _chunk(grad, sp.dim, sp.size, sp.index).contiguous(), None


def _grad_on(t: torch.Tensor) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


def _gather(local: torch.Tensor, dim: int, s: Shard) -> torch.Tensor:
    if _grad_on(local):
        return _GatherShards.apply(local, dim, s)
    return _all_gather(local, dim, s.size, s.group)


def gather(t):
    """The leaf whole over fsdp (``t`` itself unless it is an fsdp shard),
    still tagged with its tensor split."""
    s = shard_of(t)
    return t if s is None else _tag(_gather(t, s.dim, s), None, split_of(t))


def gather_layer(t, l: int):
    """Layer ``l`` of a leaf stacked on its leading L axis, whole over fsdp,
    still tagged with its tensor split."""
    s = shard_of(t)
    out = t[l] if s is None else _gather(t[l], s.dim - 1, s)
    return _tag(out, None, split_of(t))


def gather_whole(t):
    """The whole leaf, over fsdp and over ``tensor``: for the leaves the
    models read whole (the projector)."""
    out = gather(t)
    sp = _cut_over_tensor(t)
    if sp is None:
        return out
    if _grad_on(out):
        return _GatherSplit.apply(out, sp)
    return _all_gather(out, sp.dim, sp.size, sp.group)


def gather_as(t: torch.Tensor, like) -> torch.Tensor:
    """``t``, shaped as the leaf ``like`` is held (its optimizer moments,
    its gradient buffer), whole: gathered over fsdp, then over ``tensor``,
    then over ``pipe`` (the stages' layers in order), without autograd."""
    s, sp, st = shard_of(like), _cut_over_tensor(like), stage_of(like)
    out = t.detach() if is_placed(like) else t
    if s is not None:
        out = _all_gather(out, s.dim, s.size, s.group)
    if sp is not None:
        out = _all_gather(out, sp.dim, sp.size, sp.group)
    if st is not None:
        out = _all_gather(out, 0, st.size, st.group)
    return out


def gather_tree(tree: Any) -> Any:
    """Every leaf whole (every process of the mesh must call it)."""
    return map_paths(lambda _, leaf: gather_as(leaf, leaf) if is_placed(leaf) else leaf, tree)


def whole_outside_layers(tree: Any) -> Any:
    """The tree with every placed leaf outside the towers' ``layers``
    (projector, positions) gathered whole once, for an engine that reads
    them at every step; the layers stay placed, and a vocabulary leaf
    split over ``tensor`` keeps its slice (gathered over fsdp alone)."""

    def one(path, leaf):
        if "/layers/" in f"/{path}" or not is_placed(leaf):
            return leaf
        sp, s = _cut_over_tensor(leaf), shard_of(leaf)
        if sp is None or not re.fullmatch(VOCAB_LEAVES, path):
            return gather_as(leaf, leaf)
        if s is None:
            return leaf
        return _tag(_all_gather(leaf.detach(), s.dim, s.size, s.group), None, sp)

    return map_paths(one, tree)


# --------------------------------------------------------------------------
# the vocabulary over ``tensor``
# --------------------------------------------------------------------------

def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the embedding ``table`` (V, D): with a vocabulary
    split (``split_of``; none where ``tensor`` does not divide V, as in
    JAX), each rank reads the ids of its own slice, zeroes the others,
    and one all-reduce over ``tensor`` adds the parts (its backward is the
    identity: each rank's rows take their own gradient)."""
    w = gather(table)
    sp = split_of(table)
    if sp is None:
        return w[ids]
    n = w.shape[sp.dim]
    local = ids - sp.index * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[..., None], w[torch.where(mine, local, 0)], 0)
    return from_tensor(rows, sp)


def gather_logits(logits: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """The whole vocabulary rows of this rank's slice ``logits`` (..., V /
    tensor) of ``split``'s leaf, gathered over ``tensor``; the backward
    keeps this rank's slice of a gradient every peer computes alike."""
    if split is None:
        return logits
    sp = dataclasses.replace(split, dim=-1)
    if _grad_on(logits):
        return _GatherSplit.apply(logits, sp).contiguous()
    return _all_gather(logits, -1, sp.size, sp.group).contiguous()


# --------------------------------------------------------------------------
# Megatron: the products inside a layer
# --------------------------------------------------------------------------


class _ToTensor(torch.autograd.Function):
    """Identity forward, all-reduce (sum) over ``tensor`` backward: what a
    value used whole by every tensor rank's slice of a product needs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromTensor(torch.autograd.Function):
    """All-reduce (sum) over ``tensor`` forward, identity backward: the
    partial sums of a row-split product made whole."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_tensor(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """``x`` entering the tensor-split products of ``split``'s group: the
    same value, whose gradient is summed over the group."""
    if split is None or split.group is None or not _grad_on(x):
        return x
    return _ToTensor.apply(x, split.group)


def from_tensor(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """A row-split product's partial sums added over ``split``'s group."""
    if split is None or split.group is None:
        return x
    if _grad_on(x):
        return _FromTensor.apply(x, split.group)
    x = x.contiguous()
    dist.all_reduce(x, group=split.group)
    return x


def tensor_cols(t: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """This rank's last-axis elements of a whole leaf beside a column-split
    one (a bias the rules keep whole, a LoRA factor), or the K/V heads of
    a kept leaf; its gradient is summed over the group."""
    t = to_tensor(t, split)
    if split.cols is not None:
        return t[..., split.cols[0]:split.cols[1]]
    return _chunk(t, -1, split.size, split.index)


def tensor_rows(t: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """This rank's rows (dim -2) of a whole leaf beside a row-split one."""
    return _chunk(to_tensor(t, split), -2, split.size, split.index)


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) ``t`` in place over ``group``; nothing without one."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _bucketed_all_reduce(out: List[torch.Tensor], groups: Sequence[Tuple[int, Any]]) -> None:
    """Sum ``out[i]`` over its group for each (i, group), in place of the
    list: one all-reduce per group and dtype, on a flat buffer."""
    buckets: List[Tuple[Any, torch.dtype, List[int]]] = []
    for i, group in groups:
        for b in buckets:
            if b[0] is group and b[1] == out[i].dtype:
                b[2].append(i)
                break
        else:
            buckets.append((group, out[i].dtype, [i]))
    for group, _, idx in buckets:
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])


def reduce_gradients(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     mesh: Mesh) -> List[torch.Tensor]:
    """Each gradient summed over the processes that hold the same leaf and
    split the batch: an fsdp shard's (already summed over fsdp by its
    gather's backward) over ``data``, any other leaf's over the batch axes.
    Never over ``tensor``: a split leaf's peers hold other slices, and a
    whole leaf's peers the same gradient. Then a leaf every stage holds is
    summed over ``pipe`` (each stage computed its own part: the embedding
    side on the stages that fed the pipeline, the head side on the last
    one, zero elsewhere); a stage slice's gradient is its stage's alone.
    One all-reduce per group and dtype, on a flat buffer."""
    out = list(grads)
    batch = [(i, mesh.groups["data"] if shard_of(p) is not None else mesh.batch_group)
             for i, p in enumerate(params)]
    _bucketed_all_reduce(out, [(i, g) for i, g in batch if g is not None])
    pipe = mesh.groups["pipe"]
    if pipe is not None:
        _bucketed_all_reduce(out, [(i, pipe) for i, p in enumerate(params)
                                   if stage_of(p) is None])
    return out


def _sq_sum(sqs: Sequence[torch.Tensor], like: Sequence[torch.Tensor]):
    """The squares' sums ``sqs`` of the leaves ``like`` added into one:
    a whole leaf's counts once, the parts' are added over their fsdp
    group and over their tensor group."""
    whole, f_parts, t_parts, ft_parts = [], [], [], []
    f_group = t_group = None
    for sq, p in zip(sqs, like):
        s, sp = shard_of(p), _cut_over_tensor(p)
        if s is not None:
            f_group = s.group
        if sp is not None:
            t_group = sp.group
        {(False, False): whole, (True, False): f_parts, (False, True): t_parts,
         (True, True): ft_parts}[(s is not None, sp is not None)].append(sq)
    total = sum(whole)
    if f_parts:
        total = total + all_reduce_(sum(f_parts), f_group)
    if t_parts or ft_parts:
        part = sum(t_parts) if t_parts else 0
        if ft_parts:
            part = part + all_reduce_(sum(ft_parts), f_group)
        total = total + all_reduce_(part, t_group)
    return total


def sq_sum(tensors: Iterable[torch.Tensor], like: Sequence[torch.Tensor]) -> torch.Tensor:
    """fp32 sum of squares of every element of the whole leaves, from
    ``tensors`` shaped as the leaves ``like`` hold them: a whole leaf
    counts once, the parts' sums are added over their fsdp group and over
    their tensor group, and the stage slices' over ``pipe``."""
    sqs = [(t.float() * t.float()).sum() for t in tensors]
    staged = [stage_of(p) is not None for p in like]
    if not any(staged):
        return _sq_sum(sqs, like)
    pick = lambda xs, flag: [x for x, s in zip(xs, staged) if s == flag]  # noqa: E731
    part = _sq_sum(pick(sqs, True), pick(like, True))
    group = next(stage_of(p) for p in like if stage_of(p) is not None).group
    return _sq_sum(pick(sqs, False), pick(like, False)) + all_reduce_(part, group)
