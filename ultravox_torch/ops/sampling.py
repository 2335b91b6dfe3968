"""Token sampling: greedy, temperature, top-k, top-p, min-p.

Sampled draws use an explicit ``torch.Generator``; they cannot reproduce the
JAX package's threefry draws, only its distribution. Greedy is exact.

``sample_slots`` is the serving engine's per-row sampler: each row carries
its own parameters in a (B, >=4) ``[temperature, top_k, top_p, min_p]``
tensor. Where the JAX package decides on the device whether any row samples
or filters (``lax.cond``), the port takes both answers from the host
(``sampling_flags`` of the host copy of the parameters), since an ``if`` on
a device tensor would wait for the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def sampling_flags(samp: np.ndarray) -> Tuple[bool, bool]:
    """(any row samples, any row filters) of a host (B, >=4) parameter
    array: the two branches ``sample_slots`` takes."""
    samp = np.asarray(samp)
    sampled = bool((samp[:, 0] > 0).any())
    filtered = bool(((samp[:, 1] > 0) | (samp[:, 2] < 1.0) | (samp[:, 3] > 0)).any())
    return sampled, filtered


def scale_and_filter_logits(
    logits: torch.Tensor,  # (B, V)
    samp: torch.Tensor,  # (B, >=4) float32
    *,
    filtered: bool,
) -> torch.Tensor:
    """Temperature-scaled fp32 logits with each row's top-k / top-p / min-p
    filter applied (filtered entries -inf). ``filtered=False`` skips the
    sort; it is exact whenever no row enables a filter."""
    temps, top_ks, top_ps, min_ps = samp[:, 0], samp[:, 1], samp[:, 2], samp[:, 3]
    scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    if not filtered:
        return scaled
    V = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(V, device=scaled.device)[None]
    k = top_ks.to(torch.int32)[:, None]
    keep = torch.where(k > 0, ranks < k, True)
    # keep tokens until the cumulative probability exceeds top_p (top-1 always)
    keep &= (cum - probs) <= top_ps[:, None]
    keep &= probs >= min_ps[:, None] * probs[:, :1]
    inf = torch.tensor(float("inf"), device=scaled.device)
    cutoff = torch.where(keep, desc, inf).amin(dim=-1, keepdim=True)
    return torch.where(scaled < cutoff, -inf, scaled)


def sample_slots(
    logits: torch.Tensor,  # (B, V)
    samp: torch.Tensor,  # (B, >=4) float32: temperature, top_k, top_p, min_p
    generator: Optional[torch.Generator],
    *,
    sampled: bool,
    filtered: bool,
) -> torch.Tensor:
    """Next token ids (B,) int32: argmax where a row's temperature is 0, else
    a draw from its scaled and filtered distribution. ``sampled`` and
    ``filtered`` come from ``sampling_flags`` on the host. The draw is the
    exponential race (argmax of p / E with E ~ Exp(1)), which is what
    ``torch.multinomial`` computes for one sample, without its validity
    check that reads a value back from the card."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    probs = torch.softmax(scale_and_filter_logits(logits, samp, filtered=filtered), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    race.clamp_(min=torch.finfo(torch.float32).tiny)
    drawn = torch.argmax(probs / race, dim=-1).to(torch.int32)
    return torch.where(samp[:, 0] > 0, drawn, greedy)
