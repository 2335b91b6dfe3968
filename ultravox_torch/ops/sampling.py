"""Token sampling: greedy, temperature, top-k, top-p, min-p.

Sampled draws use an explicit ``torch.Generator``; they cannot reproduce the
JAX package's threefry draws, only its distribution. Greedy is exact.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_token(
    logits: torch.Tensor,  # (B, V)
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Next token ids (B,) int32."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability exceeds top_p
        cutoff_mask = cum - probs > top_p
        inf = torch.tensor(float("inf"), device=logits.device)
        cutoff = torch.where(cutoff_mask, inf, sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    if min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        logits = torch.where(probs < min_p * pmax, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
