"""Checkpoints and parameter conversion into the port's tensors.

The counterpart of the JAX package's ``models/weights.py``: fixie-ai
Ultravox checkpoints (and the Whisper / wav2vec2 / Llama / Mistral / Gemma /
Qwen checkpoints beneath them) load into the same stacked-layer trees
(``language_model``, ``audio_tower``, ``projector``) that
``from_jax_params`` gives, from a flat ``{name: tensor}`` state dict:

- safetensors files in a checkpoint directory (``load_safetensors_dir``),
  read by hand, memory-mapped, each tensor in its stored dtype; no
  ``safetensors`` package is needed (``save_safetensors`` writes the format);
- an in-memory torch ``state_dict()`` (``from_torch_state_dict``).

Linear weights are transposed from torch's (out, in) to (in, out) and
per-layer tensors stacked on a leading layer axis, on the target device.
``decoder_to_hf`` and ``projector_to_hf`` go the other way.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from ultravox_torch.models.config import (
    DecoderConfig,
    UltravoxConfig,
    Wav2Vec2EncoderConfig,
    WhisperEncoderConfig,
)

logger = logging.getLogger(__name__)

FlatDict = Dict[str, torch.Tensor]
Params = Dict[str, Any]

# safetensors dtype code -> (numpy dtype the bytes are read as, torch dtype);
# numpy has no bfloat16, so BF16 bytes are read as int16 and viewed
_ST_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_ST_CODES = {t: code for code, (_, t) in _ST_DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def _to_tensor(a: np.ndarray, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: same bits as torch's
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def read_safetensors(path: str) -> FlatDict:
    """The tensors of one safetensors file: an 8-byte little-endian header
    length, a JSON header of ``dtype``, ``shape`` and ``data_offsets``
    (relative to the end of the header) per tensor plus an optional
    ``__metadata__`` (skipped), then the raw bytes. The file is
    memory-mapped copy-on-write; each tensor is a view of the mapping in its
    stored dtype (a tensor whose offset is not a multiple of its element
    size is copied)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    base = 8 + n
    size = os.path.getsize(path)
    buf = np.memmap(path, dtype=np.uint8, mode="c") if size > base else np.zeros(0, np.uint8)
    out: FlatDict = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        np_dt, t_dt = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = np.dtype(np_dt).itemsize
        if end - start != math.prod(shape) * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} has offsets {start}-{end} for shape {shape}")
        raw = buf[base + start: base + end]
        if (base + start) % itemsize:
            raw = np.array(raw)  # an aligned copy
        t = torch.from_numpy(raw.view(np_dt).reshape(shape))
        out[name] = t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t
    return out


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a contiguous host array (bf16 as int16)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; F64 ... BOOL) in the safetensors
    format, each in its own dtype. Tensors are laid out by element size
    (largest first) and the header is padded to 8 bytes, so every tensor
    starts on a multiple of its element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {}
    off = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _ST_CODES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors code")
        nb = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nb]}
        off += nb
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for name in order:
            f.write(_host_array(tensors[name]).reshape(-1).view(np.uint8))


def save_safetensors_dir(sd: Dict[str, torch.Tensor], out_dir: str, shards: int = 1) -> None:
    """``model.safetensors``, or with ``shards`` > 1 the files
    ``model-0000i-of-0000n.safetensors`` (keys in name order, split at even
    byte counts) and ``model.safetensors.index.json``."""
    os.makedirs(out_dir, exist_ok=True)
    if shards <= 1:
        save_safetensors(sd, os.path.join(out_dir, "model.safetensors"))
        return
    names = sorted(sd)
    sizes = [sd[k].numel() * sd[k].element_size() for k in names]
    total = sum(sizes)
    groups = [[] for _ in range(shards)]
    acc = 0
    for name, nb in zip(names, sizes):
        groups[min(shards - 1, acc * shards // max(total, 1))].append(name)
        acc += nb
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_safetensors({k: sd[k] for k in group}, os.path.join(out_dir, fname))
        weight_map.update({k: fname for k in group})
    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)


def load_safetensors_dir(model_dir: str) -> FlatDict:
    """All tensors of a checkpoint directory in one flat dict: the files
    named by ``model.safetensors.index.json`` when there is one, else every
    ``*.safetensors`` file."""
    index_path = os.path.join(model_dir, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    out: FlatDict = {}
    for fname in files:
        out.update(read_safetensors(os.path.join(model_dir, fname)))
    return out


def from_torch_state_dict(state_dict) -> FlatDict:
    return {k: v.detach().float() for k, v in state_dict.items()}


def _strip_prefix(sd: FlatDict, prefix: str) -> FlatDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


class _Reader:
    """Flat-dict reader: each leaf moved to ``device``, then transposed,
    stacked and cast to ``dtype`` there (floating leaves only). Every leaf
    owns its memory: none is a view of a memory-mapped file."""

    def __init__(self, sd: FlatDict, dtype, device=None):
        self.sd = sd
        self.dtype = dtype
        self.device = torch.device("cpu") if device is None else torch.device(device)

    def __call__(self, name: str, transpose: bool = False) -> torch.Tensor:
        t = self.sd[name].to(self.device, copy=True)
        if transpose:
            t = t.T
        return _cast(t, self.dtype).contiguous()

    def has(self, name: str) -> bool:
        return name in self.sd

    def stack(self, pattern: str, num_layers: int, transpose: bool = False) -> torch.Tensor:
        ts = [self.sd[pattern.format(i=i)].to(self.device) for i in range(num_layers)]
        return _cast(torch.stack([t.T if transpose else t for t in ts]), self.dtype)


def convert_whisper_encoder(
    sd: FlatDict, cfg: WhisperEncoderConfig, dtype=torch.float32, device=None
) -> Params:
    """HF WhisperEncoder state dict (keys like ``conv1.weight``,
    ``layers.0.self_attn.q_proj.weight``) -> encoder param tree."""
    r = _Reader(sd, dtype, device)
    L = cfg.num_layers

    def ln(stem):
        return {"scale": r.stack(stem + ".weight", L), "bias": r.stack(stem + ".bias", L)}

    def lin(stem, bias=True):
        p = {"kernel": r.stack(stem + ".weight", L, transpose=True)}
        if bias:
            p["bias"] = r.stack(stem + ".bias", L)
        return p

    return {
        # torch Conv1d weight (out, in, k) -> the tree's (k, in, out)
        "conv1": {
            "kernel": r("conv1.weight").permute(2, 1, 0).contiguous(),
            "bias": r("conv1.bias"),
        },
        "conv2": {
            "kernel": r("conv2.weight").permute(2, 1, 0).contiguous(),
            "bias": r("conv2.bias"),
        },
        "embed_positions": r("embed_positions.weight"),
        "layers": {
            "attn_ln": ln("layers.{i}.self_attn_layer_norm"),
            "q_proj": lin("layers.{i}.self_attn.q_proj"),
            "k_proj": lin("layers.{i}.self_attn.k_proj", bias=False),
            "v_proj": lin("layers.{i}.self_attn.v_proj"),
            "out_proj": lin("layers.{i}.self_attn.out_proj"),
            "final_ln": ln("layers.{i}.final_layer_norm"),
            "fc1": lin("layers.{i}.fc1"),
            "fc2": lin("layers.{i}.fc2"),
        },
        "layer_norm": {"scale": r("layer_norm.weight"), "bias": r("layer_norm.bias")},
    }


def convert_wav2vec2_encoder(
    sd: FlatDict, cfg: Wav2Vec2EncoderConfig, dtype=torch.float32, device=None
) -> Params:
    """HF Wav2Vec2Model state dict (prefix stripped: keys like
    ``feature_extractor.conv_layers.0.conv.weight``) -> wav2vec2 tower
    tree (``models/wav2vec2_encoder.py``)."""
    r = _Reader(sd, dtype, device)
    L = cfg.num_layers

    def conv_kernel(name):  # torch Conv1d (out, in, k) -> the tree's (k, in, out)
        return r(name).permute(2, 1, 0).contiguous()

    convs = []
    for i in range(len(cfg.conv_dim)):
        stem = f"feature_extractor.conv_layers.{i}"
        conv: Params = {"kernel": conv_kernel(f"{stem}.conv.weight")}
        if f"{stem}.conv.bias" in sd:
            conv["bias"] = r(f"{stem}.conv.bias")
        if f"{stem}.layer_norm.weight" in sd:
            conv["norm"] = {
                "scale": r(f"{stem}.layer_norm.weight"),
                "bias": r(f"{stem}.layer_norm.bias"),
            }
        convs.append(conv)

    # the weight-normalised positional conv: weight = g * v / ||v|| over
    # dims (0, 1) (torch weight_norm, dim=2), the norm in float64 as the
    # JAX package takes it; keys weight_g / weight_v, or the newer
    # parametrizations.weight.original0 / original1
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        g, v = sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"]
    else:
        g = sd[f"{pc}.parametrizations.weight.original0"]
        v = sd[f"{pc}.parametrizations.weight.original1"]
    g, v = g.to(r.device), v.to(r.device)
    norm = v.double().square().sum(dim=(0, 1), keepdim=True).sqrt()
    pos_kernel = ((g * v) / norm.clamp(min=1e-12)).float()

    def ln(stem):
        return {"scale": r.stack(stem + ".weight", L), "bias": r.stack(stem + ".bias", L)}

    def lin(stem):
        return {"kernel": r.stack(stem + ".weight", L, transpose=True),
                "bias": r.stack(stem + ".bias", L)}

    return {
        "feature_extractor": convs,
        "feature_projection": {
            "ln": {
                "scale": r("feature_projection.layer_norm.weight"),
                "bias": r("feature_projection.layer_norm.bias"),
            },
            "projection": {
                "kernel": r("feature_projection.projection.weight", transpose=True),
                "bias": r("feature_projection.projection.bias"),
            },
        },
        "pos_conv": {
            "kernel": _cast(pos_kernel.permute(2, 1, 0), dtype).contiguous(),
            "bias": r(f"{pc}.bias"),
        },
        "encoder_ln": {
            "scale": r("encoder.layer_norm.weight"),
            "bias": r("encoder.layer_norm.bias"),
        },
        "layers": {
            "attn_ln": ln("encoder.layers.{i}.layer_norm"),
            "q_proj": lin("encoder.layers.{i}.attention.q_proj"),
            "k_proj": lin("encoder.layers.{i}.attention.k_proj"),
            "v_proj": lin("encoder.layers.{i}.attention.v_proj"),
            "out_proj": lin("encoder.layers.{i}.attention.out_proj"),
            "final_ln": ln("encoder.layers.{i}.final_layer_norm"),
            "fc1": lin("encoder.layers.{i}.feed_forward.intermediate_dense"),
            "fc2": lin("encoder.layers.{i}.feed_forward.output_dense"),
        },
    }


def _is_wav2vec2(audio_cfg) -> bool:
    return type(audio_cfg).__name__ == "Wav2Vec2EncoderConfig"


def convert_audio_tower_checkpoint(
    sd: FlatDict, audio_cfg, dtype=torch.float32, device=None
) -> Optional[Params]:
    """Standalone audio-model checkpoint -> tower params, handling the
    common key prefixes (WhisperModel nests the encoder under
    ``model.encoder.``; Wav2Vec2ForCTC under ``wav2vec2.``). Returns None
    when the state dict does not look like the configured tower."""
    if _is_wav2vec2(audio_cfg):
        for prefix in ("wav2vec2.", ""):
            sub = _strip_prefix(sd, prefix) if prefix else sd
            if "feature_extractor.conv_layers.0.conv.weight" in sub:
                return convert_wav2vec2_encoder(sub, audio_cfg, dtype, device)
        return None
    for prefix in ("model.encoder.", "encoder.", ""):
        sub = _strip_prefix(sd, prefix) if prefix else sd
        if "conv1.weight" in sub:
            return convert_whisper_encoder(sub, audio_cfg, dtype, device)
    return None


def convert_decoder(sd: FlatDict, cfg: DecoderConfig, dtype=torch.float32, device=None) -> Params:
    """HF CausalLM state dict (``model.embed_tokens.weight``,
    ``model.layers.{i}...``, ``lm_head.weight``) -> decoder param tree."""
    r = _Reader(sd, dtype, device)
    L = cfg.num_layers
    pre = "model."

    def lin(stem, bias=False):
        p = {"kernel": r.stack(pre + stem + ".weight", L, transpose=True)}
        if bias and r.has(pre + stem.format(i=0) + ".bias"):
            p["bias"] = r.stack(pre + stem + ".bias", L)
        return p

    layers: Params = {
        "input_ln": r.stack(pre + "layers.{i}.input_layernorm.weight", L),
        "q_proj": lin("layers.{i}.self_attn.q_proj", bias=cfg.attention_bias),
        "k_proj": lin("layers.{i}.self_attn.k_proj", bias=cfg.attention_bias),
        "v_proj": lin("layers.{i}.self_attn.v_proj", bias=cfg.attention_bias),
        "o_proj": lin("layers.{i}.self_attn.o_proj"),
        "post_attn_ln": r.stack(pre + "layers.{i}.post_attention_layernorm.weight", L),
        "gate_proj": lin("layers.{i}.mlp.gate_proj"),
        "up_proj": lin("layers.{i}.mlp.up_proj"),
        "down_proj": lin("layers.{i}.mlp.down_proj"),
    }
    if cfg.qk_norm:
        layers["q_norm"] = r.stack(pre + "layers.{i}.self_attn.q_norm.weight", L)
        layers["k_norm"] = r.stack(pre + "layers.{i}.self_attn.k_norm.weight", L)
    if cfg.use_post_norms:
        layers["pre_ffn_ln"] = r.stack(pre + "layers.{i}.pre_feedforward_layernorm.weight", L)
        layers["post_ffn_ln"] = r.stack(pre + "layers.{i}.post_feedforward_layernorm.weight", L)

    params: Params = {
        "embed_tokens": r(pre + "embed_tokens.weight"),
        "layers": layers,
        "norm": r(pre + "norm.weight"),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": r("lm_head.weight", transpose=True)}
    return params


def convert_projector(sd: FlatDict, cfg: UltravoxConfig, dtype=torch.float32, device=None) -> Params:
    """Fixie checkpoint projector keys (``ln_pre.weight``, ``linear_1.weight``,
    ``ln_mid.weight`` / ``ln_post.weight``, ``linear_2.weight``)."""
    r = _Reader(sd, dtype, device)
    params: Params = {
        "ln_pre": r("ln_pre.weight"),
        "linear_1": {"kernel": r("linear_1.weight", transpose=True)},
        "linear_2": {"kernel": r("linear_2.weight", transpose=True)},
    }
    if "ln_mid.weight" in sd:
        params["ln_mid"] = r("ln_mid.weight")
    if "ln_post.weight" in sd:
        params["ln_post"] = r("ln_post.weight")
    return params


def convert_ultravox(
    sd: FlatDict,
    cfg: UltravoxConfig,
    dtype=torch.float32,
    *,
    base: Optional[Params] = None,
    device=None,
) -> Params:
    """Convert a fixie-ai Ultravox state dict (possibly a *diff* checkpoint
    holding only trainable params) into the composite param tree.

    ``base`` provides pre-loaded sub-model params (e.g. the frozen LLM and
    encoder loaded from their own checkpoints); keys present in ``sd``
    override it. A state dict that only partially covers a tower (e.g.
    ``unfreeze_layers`` diff checkpoints) is overlaid per key onto the base
    tower when one exists, and skipped with a warning otherwise. The base
    tree is not modified."""
    params: Params = dict(base or {})
    proj_sd = _strip_prefix(sd, "multi_modal_projector.")
    if proj_sd:
        params["projector"] = convert_projector(proj_sd, cfg, dtype, device)
    audio_sd = _strip_prefix(sd, "audio_tower.")
    if audio_sd:
        if _covers_encoder(audio_sd, cfg.audio_config):
            convert = (convert_wav2vec2_encoder if _is_wav2vec2(cfg.audio_config)
                       else convert_whisper_encoder)
            params["audio_tower"] = convert(audio_sd, cfg.audio_config, dtype, device)
        elif "audio_tower" in params:
            params["audio_tower"] = _overlay_encoder(params["audio_tower"], audio_sd, cfg.audio_config, dtype)
        else:
            logger.warning(
                "state dict holds %d audio_tower keys that neither cover the "
                "encoder nor have a base to overlay; IGNORED: %s",
                len(audio_sd), sorted(audio_sd)[:8],
            )
    lm_sd = _strip_prefix(sd, "language_model.")
    if lm_sd:
        if _covers_decoder(lm_sd, cfg.text_config):
            params["language_model"] = convert_decoder(lm_sd, cfg.text_config, dtype, device)
        elif "language_model" in params:
            params["language_model"] = _overlay_decoder(
                params["language_model"], lm_sd, cfg.text_config, dtype)
        else:
            logger.warning(
                "state dict holds %d language_model keys that neither cover "
                "the decoder nor have a base to overlay; IGNORED: %s",
                len(lm_sd), sorted(lm_sd)[:8],
            )
    return params


_DEC_LIN = {
    "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj", "self_attn.o_proj": "o_proj",
    "mlp.gate_proj": "gate_proj", "mlp.up_proj": "up_proj",
    "mlp.down_proj": "down_proj",
}
_DEC_NORM = {
    "input_layernorm": "input_ln",
    "post_attention_layernorm": "post_attn_ln",
    "pre_feedforward_layernorm": "pre_ffn_ln",
    "post_feedforward_layernorm": "post_ffn_ln",
    "self_attn.q_norm": "q_norm",
    "self_attn.k_norm": "k_norm",
}
_ENC_LIN = {
    "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj", "self_attn.out_proj": "out_proj",
    "fc1": "fc1", "fc2": "fc2",
}
_ENC_NORM = {"self_attn_layer_norm": "attn_ln", "final_layer_norm": "final_ln"}


def _decoder_key_to_path(name: str):
    """HF decoder key -> (tree path, layer idx or None, transpose flag)."""
    if name == "model.embed_tokens.weight":
        return ("embed_tokens",), None, False
    if name == "model.norm.weight":
        return ("norm",), None, False
    if name == "lm_head.weight":
        return ("lm_head", "kernel"), None, True
    m = re.match(r"^model\.layers\.(\d+)\.(.+)\.(weight|bias)$", name)
    if not m:
        return None
    idx, stem, leaf = int(m.group(1)), m.group(2), m.group(3)
    if stem in _DEC_NORM and leaf == "weight":
        return ("layers", _DEC_NORM[stem]), idx, False
    if stem in _DEC_LIN:
        sub = "kernel" if leaf == "weight" else "bias"
        return ("layers", _DEC_LIN[stem], sub), idx, leaf == "weight"
    return None


def _encoder_key_to_path(name: str):
    """HF whisper-encoder key -> (path, layer idx, transform in {None,'T','conv'})."""
    if name == "embed_positions.weight":
        return ("embed_positions",), None, None
    m = re.match(r"^(conv[12])\.(weight|bias)$", name)
    if m:
        conv, leaf = m.groups()
        if leaf == "weight":
            return (conv, "kernel"), None, "conv"
        return (conv, "bias"), None, None
    m = re.match(r"^layer_norm\.(weight|bias)$", name)
    if m:
        return ("layer_norm", "scale" if m.group(1) == "weight" else "bias"), None, None
    m = re.match(r"^layers\.(\d+)\.(.+)\.(weight|bias)$", name)
    if not m:
        return None
    idx, stem, leaf = int(m.group(1)), m.group(2), m.group(3)
    if stem in _ENC_NORM:
        return ("layers", _ENC_NORM[stem], "scale" if leaf == "weight" else "bias"), idx, None
    if stem in _ENC_LIN:
        sub = "kernel" if leaf == "weight" else "bias"
        return ("layers", _ENC_LIN[stem], sub), idx, "T" if leaf == "weight" else None
    return None


def _tree_set(tree: Params, path, layer_idx, value: torch.Tensor, owned=None):
    """Set a leaf (or one layer of a stacked leaf) in the leaf's own dtype
    and device. A stacked leaf is copied before its first write, unless it
    is in ``owned`` (the ids of leaves this overlay already copied)."""
    node = tree
    for p in path[:-1]:
        if p not in node:
            raise KeyError(f"overlay target {'.'.join(path)} absent from base tree")
        node = node[p]
    leaf = path[-1]
    if leaf not in node:
        raise KeyError(f"overlay target {'.'.join(path)} absent from base tree")
    cur = node[leaf]
    value = value.to(cur.device, cur.dtype)
    if layer_idx is None:
        node[leaf] = value.contiguous()
        return
    if owned is None or id(cur) not in owned:
        cur = cur.clone()
        node[leaf] = cur
        if owned is not None:
            owned.add(id(cur))
    cur[layer_idx] = value


def _copy_one_level(base: Params) -> Params:
    """Shallow-copy the dict spine so overlay writes don't mutate the input."""
    out = dict(base)
    for k, v in out.items():
        if isinstance(v, dict):
            out[k] = dict(v)
    return out


def _overlay_tower(base: Params, sd: FlatDict, key_to_path, what: str) -> Params:
    """Per-key merge of a partial HF state dict onto an existing stacked-layer
    tree (diff checkpoints with ``unfreeze_layers`` / selective
    ``model_load_parameters``)."""
    out = _copy_one_level(base)
    if "layers" in out and isinstance(out["layers"], dict):
        out["layers"] = {
            k: (dict(v) if isinstance(v, dict) else v) for k, v in base["layers"].items()
        }
    applied, ignored = 0, []
    owned: set = set()
    for name, val in sd.items():
        mapped = key_to_path(name)
        if mapped is None:
            ignored.append(name)
            continue
        path, idx, transform = mapped
        if transform == "conv":
            val = val.permute(2, 1, 0)  # torch (out, in, k) -> (k, in, out)
        elif transform in (True, "T"):
            val = val.T
        _tree_set(out, path, idx, val, owned)
        applied += 1
    if ignored:
        logger.warning("partial %s overlay ignored %d unmapped keys: %s",
                       what, len(ignored), ignored[:8])
    logger.info("partial %s overlay applied %d keys", what, applied)
    return out


def _overlay_decoder(base: Params, sd: FlatDict, cfg: DecoderConfig, dtype) -> Params:
    return _overlay_tower(base, sd, _decoder_key_to_path, "decoder")


_W2V_LIN = {
    "attention.q_proj": "q_proj", "attention.k_proj": "k_proj",
    "attention.v_proj": "v_proj", "attention.out_proj": "out_proj",
    "feed_forward.intermediate_dense": "fc1",
    "feed_forward.output_dense": "fc2",
}
_W2V_NORM = {"layer_norm": "attn_ln", "final_layer_norm": "final_ln"}


def _wav2vec2_key_to_path(name: str):
    """HF wav2vec2 key -> overlay path. The weight-normalised positional
    conv and the conv stack are left to the full converter: trainable
    diffs never hold them."""
    m = re.match(r"^feature_projection\.layer_norm\.(weight|bias)$", name)
    if m:
        return ("feature_projection", "ln",
                "scale" if m.group(1) == "weight" else "bias"), None, None
    m = re.match(r"^feature_projection\.projection\.(weight|bias)$", name)
    if m:
        leaf = "kernel" if m.group(1) == "weight" else "bias"
        return ("feature_projection", "projection", leaf), None, "T" if leaf == "kernel" else None
    m = re.match(r"^encoder\.layer_norm\.(weight|bias)$", name)
    if m:
        return ("encoder_ln", "scale" if m.group(1) == "weight" else "bias"), None, None
    m = re.match(r"^encoder\.layers\.(\d+)\.(.+)\.(weight|bias)$", name)
    if not m:
        return None
    idx, stem, leaf = int(m.group(1)), m.group(2), m.group(3)
    if stem in _W2V_NORM:
        return ("layers", _W2V_NORM[stem], "scale" if leaf == "weight" else "bias"), idx, None
    if stem in _W2V_LIN:
        sub = "kernel" if leaf == "weight" else "bias"
        return ("layers", _W2V_LIN[stem], sub), idx, "T" if leaf == "weight" else None
    return None


def _overlay_encoder(base: Params, sd: FlatDict, cfg, dtype) -> Params:
    if _is_wav2vec2(cfg):
        return _overlay_tower(base, sd, _wav2vec2_key_to_path, "wav2vec2")
    return _overlay_tower(base, sd, _encoder_key_to_path, "encoder")


def _covers_encoder(sd: FlatDict, cfg) -> bool:
    """True only when the state dict holds everything the full converter
    reads: layer stacks and the non-layer leaves (a diff checkpoint that
    unfreezes every layer but not the conv stack takes the per-key overlay
    path)."""
    if _is_wav2vec2(cfg):
        return (
            "feature_extractor.conv_layers.0.conv.weight" in sd
            and "feature_projection.projection.weight" in sd
            and "encoder.layer_norm.weight" in sd
            and all(f"encoder.layers.{i}.attention.q_proj.weight" in sd
                    for i in range(cfg.num_layers))
        )
    return (
        "conv1.weight" in sd
        and "embed_positions.weight" in sd
        and "layer_norm.weight" in sd
        and all(f"layers.{i}.self_attn.q_proj.weight" in sd for i in range(cfg.num_layers))
    )


def _covers_decoder(sd: FlatDict, cfg: DecoderConfig) -> bool:
    return (
        "model.embed_tokens.weight" in sd
        and "model.norm.weight" in sd
        and all(f"model.layers.{i}.self_attn.q_proj.weight" in sd for i in range(cfg.num_layers))
    )


# --------------------------------------------------------------------------
# Reverse conversion (for publishing checkpoints loadable by the reference)
# --------------------------------------------------------------------------


def _hf(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A leaf for an HF state dict: detached, in ``dtype`` (None keeps the
    leaf's), on its own device; the writer makes it contiguous."""
    t = t.detach()
    return t if dtype is None else t.to(dtype)


def decoder_to_hf(params: Params, cfg: DecoderConfig, dtype=torch.float32) -> FlatDict:
    """Decoder tree -> HF CausalLM state dict, each tensor in ``dtype``
    (fp32 as the reference writes; None keeps each leaf's dtype)."""
    out: FlatDict = {}
    ly = params["layers"]

    def unstack(name_pattern, arr, transpose=False):
        a = _hf(arr, dtype)
        for i in range(cfg.num_layers):
            out[name_pattern.format(i=i)] = a[i].T if transpose else a[i]

    out["model.embed_tokens.weight"] = _hf(params["embed_tokens"], dtype)
    out["model.norm.weight"] = _hf(params["norm"], dtype)
    if "lm_head" in params:
        out["lm_head.weight"] = _hf(params["lm_head"]["kernel"], dtype).T
    unstack("model.layers.{i}.input_layernorm.weight", ly["input_ln"])
    unstack("model.layers.{i}.post_attention_layernorm.weight", ly["post_attn_ln"])
    for hf, mine in [
        ("self_attn.q_proj", "q_proj"),
        ("self_attn.k_proj", "k_proj"),
        ("self_attn.v_proj", "v_proj"),
        ("self_attn.o_proj", "o_proj"),
        ("mlp.gate_proj", "gate_proj"),
        ("mlp.up_proj", "up_proj"),
        ("mlp.down_proj", "down_proj"),
    ]:
        unstack("model.layers.{i}." + hf + ".weight", ly[mine]["kernel"], transpose=True)
        if "bias" in ly[mine]:
            unstack("model.layers.{i}." + hf + ".bias", ly[mine]["bias"])
    if "q_norm" in ly:
        unstack("model.layers.{i}.self_attn.q_norm.weight", ly["q_norm"])
        unstack("model.layers.{i}.self_attn.k_norm.weight", ly["k_norm"])
    if "pre_ffn_ln" in ly:
        unstack("model.layers.{i}.pre_feedforward_layernorm.weight", ly["pre_ffn_ln"])
        unstack("model.layers.{i}.post_feedforward_layernorm.weight", ly["post_ffn_ln"])
    return out


def projector_to_hf(params: Params, dtype=torch.float32) -> FlatDict:
    out: FlatDict = {
        "ln_pre.weight": _hf(params["ln_pre"], dtype),
        "linear_1.weight": _hf(params["linear_1"]["kernel"], dtype).T,
        "linear_2.weight": _hf(params["linear_2"]["kernel"], dtype).T,
    }
    if "ln_mid" in params:
        out["ln_mid.weight"] = _hf(params["ln_mid"], dtype)
    if "ln_post" in params:
        out["ln_post.weight"] = _hf(params["ln_post"], dtype)
    return out


def from_jax_params(
    np_tree: Any,
    cfg: UltravoxConfig,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """The JAX package's parameter pytree, given as nested dicts (and the
    wav2vec2 conv stack's list) of numpy arrays, as the port's tensors: the
    same keys, lists and stacked (L, ...) layer layout, so no leaf is
    reshaped. Floating leaves are cast to ``dtype`` when given; ``device``
    defaults to the CPU.
    """
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):  # the wav2vec2 conv stack
            return [conv(v) for v in node]
        return _to_tensor(node, device, dtype)

    params = conv(np_tree)
    lm = params.get("language_model", {})
    if "layers" in lm:
        L = next(iter(_leaves(lm["layers"]))).shape[0]
        if L != cfg.text_config.num_layers:
            raise ValueError(
                f"decoder tree has {L} layers, config says {cfg.text_config.num_layers}"
            )
    tower = params.get("audio_tower", {})
    if "layers" in tower:
        L = next(iter(_leaves(tower["layers"]))).shape[0]
        if L != cfg.audio_config.num_layers:
            raise ValueError(
                f"encoder tree has {L} layers, config says {cfg.audio_config.num_layers}"
            )
    return params


def _leaves(node):
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node
