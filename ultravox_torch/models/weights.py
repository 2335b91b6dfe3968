"""Parameter conversion into the port's tensors."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ultravox_torch.models.config import UltravoxConfig


def _to_tensor(a: np.ndarray, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: same bits as torch's
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(
    np_tree: Any,
    cfg: UltravoxConfig,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """The JAX package's parameter pytree, given as nested dicts of numpy
    arrays, as the port's nested dicts of tensors: the same keys and the
    same stacked (L, ...) layer layout, so no leaf is reshaped. Floating
    leaves are cast to ``dtype`` when given; ``device`` defaults to the CPU.
    """
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
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
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
