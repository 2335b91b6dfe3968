"""Projector surgery: synthesize a projector for a larger LLM from a
smaller LLM's, without training, through a least-squares linear map
between the two LLMs' token-embedding spaces.

1. fit ``M`` minimising ||E_small M - E_big|| over shared vocabulary rows
   (closed-form ridge least squares, in fp64);
2. compose the small projector's final linear with ``M`` so its outputs
   land in the big model's embedding space: ``linear_2' = linear_2 @ M``
   (and the post-norm is refit on M's output scale when present).

Everything runs on the tensors' device: given CUDA tensors, the fit runs
on the card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def fit_embedding_map(emb_small, emb_big, ridge: float = 1e-4) -> torch.Tensor:
    """Closed-form ridge regression in fp64: M = (X^T X + ridge I)^-1 X^T Y,
    (d_small, d_big) in fp32, from X = ``emb_small`` (V, d_small) and Y =
    ``emb_big`` (V, d_big)."""
    X = _tensor(emb_small).double()
    Y = _tensor(emb_big).to(X.device).double()
    d = X.shape[1]
    gram = X.T @ X + ridge * torch.eye(d, dtype=torch.float64, device=X.device)
    return torch.linalg.solve(gram, X.T @ Y).float()


def combine_projector(projector_params: Dict[str, Any], embedding_map) -> Dict[str, Any]:
    """Compose the final projector linear with the embedding map. If the
    projector ends with an ``ln_post`` RMSNorm (the pre-v0.5 layout), its
    weight is mapped through the map's per-column L2 mass as an
    approximation, which training should touch up."""
    M = _tensor(embedding_map)
    out = dict(projector_params)
    l2 = _tensor(projector_params["linear_2"]["kernel"]).float()
    M32 = M.to(l2.device).float()
    out["linear_2"] = {"kernel": l2 @ M32}
    if "ln_post" in projector_params:
        # ln_post lives in the output space; rescale by the map's per-column
        # L2 mass so activation scales stay comparable
        w = _tensor(projector_params["ln_post"]).float()
        col_scale = torch.sqrt((M32.double() ** 2).sum(0))
        mean_in = float(w.mean())
        scale = (col_scale / max(float(col_scale.mean()), 1e-8)).float()
        out["ln_post"] = torch.full((M.shape[1],), mean_in, dtype=torch.float32,
                                    device=scale.device) * scale
    return out


def upproject_adapter(projector_params: Dict[str, Any], emb_small, emb_big,
                      ridge: float = 1e-4) -> Dict[str, Any]:
    """One call from a small LLM's projector to a big LLM's (8B to 70B
    style): ``fit_embedding_map``, then ``combine_projector``."""
    return combine_projector(projector_params, fit_embedding_map(emb_small, emb_big, ridge))
