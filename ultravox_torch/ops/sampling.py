"""Token sampling: greedy, temperature, top-k, top-p, min-p; the serving
penalties (``apply_penalties``) and logprobs (``token_logprobs``).

Sampled draws use an explicit ``torch.Generator``; they cannot reproduce the
JAX package's threefry draws, only its distribution. Greedy is exact. A
seeded row (``sample_slots(seeds=...)``) draws its noise instead from a
counter-based hash of (seed, position, vocabulary index)
(``seeded_exponential``): integer arithmetic and an fp64 log, so the card
and the CPU draw the same noise, and nothing else (the batch, the
schedule) moves it.

``spec_accept_slots`` is speculative decoding's accept / reject rule against
a point-mass draft; greedy rows reduce to an argmax match.

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
    # Python-number fills: a tensor made from one would be a blocking copy
    # from host memory, which waits for the card
    cutoff = desc.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
    return scaled.masked_fill(scaled < cutoff, float("-inf"))


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in two 16-bit halves of c
    so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply, a bijection on 32 bits),
    on int64 tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seeded_bits(seeds: torch.Tensor, positions: torch.Tensor, vocab: int,
                stream: int = 0) -> torch.Tensor:
    """(B, vocab) int64 hashes in [0, 2^32) of each row's (seed, position)
    and the vocabulary index. A nonzero ``stream`` gives an independent
    family of hashes for the same (seed, position)."""
    row = _mix32(_mix32(seeds.long() & _M32) ^ (positions.long() & _M32))
    if stream:
        row = _mix32(row ^ (_mix32(torch.full_like(row, stream & _M32)) | 1))
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    return _mix32(row[:, None] ^ idx[None])


def seeded_uniform(seeds: torch.Tensor, positions: torch.Tensor, vocab: int,
                   stream: int = 0) -> torch.Tensor:
    """(B, vocab) fp64 uniforms (hash + 0.5) / 2^32 in (0, 1) of
    ``seeded_bits``."""
    return (seeded_bits(seeds, positions, vocab, stream).double() + 0.5) * 2.0**-32


def seeded_exponential(seeds: torch.Tensor, positions: torch.Tensor, vocab: int,
                       stream: int = 0) -> torch.Tensor:
    """(B, vocab) fp32 Exp(1) noise that depends only on each row's (seed,
    position) and the vocabulary index: -log(u) of ``seeded_uniform`` in
    fp64, rounded to fp32."""
    return (-torch.log(seeded_uniform(seeds, positions, vocab, stream))).float()


def sample_slots(
    logits: torch.Tensor,  # (B, V)
    samp: torch.Tensor,  # (B, >=4) float32: temperature, top_k, top_p, min_p
    generator: Optional[torch.Generator],
    *,
    sampled: bool,
    filtered: bool,
    seeds: Optional[torch.Tensor] = None,  # (B,) int32, -1 = unseeded
    positions: Optional[torch.Tensor] = None,  # (B,) int32 per-request progress
) -> torch.Tensor:
    """Next token ids (B,) int32: argmax where a row's temperature is 0, else
    a draw from its scaled and filtered distribution. ``sampled`` and
    ``filtered`` come from ``sampling_flags`` on the host. The draw is the
    exponential race (argmax of p / E with E ~ Exp(1)), which is what
    ``torch.multinomial`` computes for one sample, without its validity
    check that reads a value back from the card. Rows with seed >= 0 race
    ``seeded_exponential`` noise of (seed, position), so a seeded request
    repeats its draws whatever else shares the batch; the others draw from
    ``generator``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    probs = torch.softmax(scale_and_filter_logits(logits, samp, filtered=filtered), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    if seeds is not None:
        hashed = seeded_exponential(seeds, positions, probs.shape[-1])
        race = torch.where((seeds >= 0)[:, None], hashed, race)
    race.clamp_(min=torch.finfo(torch.float32).tiny)
    drawn = torch.argmax(probs / race, dim=-1).to(torch.int32)
    return torch.where(samp[:, 0] > 0, drawn, greedy)


# independent hash streams of a seeded row's speculative draws
_ACCEPT_STREAM = 0x51EC
_RESIDUAL_STREAM = 0x2E51


def spec_accept_slots(
    logits: torch.Tensor,  # (B, T, V) verify logits; T = K + 1
    drafts: torch.Tensor,  # (B, K) int32 proposed tokens
    samp: torch.Tensor,  # (B, >=4) float32: temperature, top_k, top_p, min_p
    generator: Optional[torch.Generator],
    *,
    sampled: bool,
    filtered: bool,
    seeds: Optional[torch.Tensor] = None,  # (B,) int32, -1 = unseeded
    positions: Optional[torch.Tensor] = None,  # (B,) absolute index of emit 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative accept / reject against a point-mass draft (prompt-lookup
    drafts are deterministic), per row with its own sampling parameters.

    Returns ``(out (B, T) int32, accepted (B,) int32 in [1, T])``: row b
    emits ``out[b, :accepted[b]]``. A greedy row (temperature 0) accepts
    draft i iff it equals the argmax of position i and emits the argmax: the
    tokens of non-speculative greedy decode. A sampled row accepts draft x_i
    with probability p_i(x_i) (p the scaled, filtered softmax); at the first
    rejection it draws from the residual (p_i with x_i removed,
    renormalised), and when all K drafts are accepted it draws a bonus token
    from p_K: the emitted tokens are distributed as ancestral sampling from
    p. ``sampled`` and ``filtered`` are ``sampling_flags`` of the host copy
    of ``samp``. Rows with seed >= 0 draw from ``seeded_uniform`` /
    ``seeded_exponential`` at ``positions + i`` (the accept test and the
    residual on independent streams), the others from ``generator``."""
    B, T, V = logits.shape
    K = T - 1
    dev = logits.device
    bidx = torch.arange(B, device=dev)
    argmaxes = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, T)
    drafts = drafts.to(torch.int32)
    acc_ok = drafts == argmaxes[:, :K]
    if sampled:
        scaled = scale_and_filter_logits(
            logits.reshape(B * T, V), samp.repeat_interleave(T, dim=0), filtered=filtered,
        ).reshape(B, T, V)
        probs = torch.softmax(scaled, dim=-1)
        u = torch.rand((B, K), generator=generator, device=dev, dtype=torch.float64)
        if seeds is not None:
            hashed = torch.stack([
                seeded_uniform(seeds, positions + i, 1, _ACCEPT_STREAM)[:, 0] for i in range(K)
            ], dim=1)
            u = torch.where((seeds >= 0)[:, None], hashed, u)
        p_draft = probs[:, :K].gather(-1, drafts.long()[..., None])[..., 0]
        acc_ok = torch.where((samp[:, 0] > 0)[:, None], u < p_draft.double(), acc_ok)
    # leading accepts: emit position ``lead`` holds the fresh token
    lead = torch.cumprod(acc_ok.to(torch.int32), dim=1).sum(dim=1)
    fresh = argmaxes[bidx, lead]
    padded = torch.cat([drafts, drafts[:, -1:]], dim=1)  # (B, T)
    if sampled:
        # the residual at the first rejection (the draft removed), the
        # bonus from p_K when every draft was accepted
        final = scaled[bidx, lead]  # (B, V)
        rejected = padded.gather(1, lead[:, None].long())[:, 0]
        kill = (lead < K)[:, None] & (torch.arange(V, device=dev)[None] == rejected[:, None])
        final_probs = torch.softmax(final.masked_fill(kill, float("-inf")), dim=-1)
        race = torch.empty_like(final_probs).exponential_(1.0, generator=generator)
        if seeds is not None:
            hashed = seeded_exponential(seeds, positions + lead, V, _RESIDUAL_STREAM)
            race = torch.where((seeds >= 0)[:, None], hashed, race)
        race.clamp_(min=torch.finfo(torch.float32).tiny)
        drawn = torch.argmax(final_probs / race, dim=-1).to(torch.int32)
        fresh = torch.where(samp[:, 0] > 0, drawn, fresh)
    out = padded.scatter(1, lead[:, None].long(), fresh[:, None])
    return out, (lead + 1).to(torch.int32)


def apply_penalties(
    logits: torch.Tensor,  # (B, V)
    out_counts: torch.Tensor,  # (B, V) int32: each row's OUTPUT token counts
    prompt_mask: torch.Tensor,  # (B, V) bool: tokens present in the prompt
    samp: torch.Tensor,  # (B, >=7) float32; cols 4..6 = presence, frequency, repetition
) -> torch.Tensor:
    """vLLM-semantics penalties per row, in fp32: the repetition penalty over
    prompt and output tokens (divides positive logits, multiplies negative
    ones; a value <= 0 counts as 1), then presence (flat) and frequency
    (count-proportional) penalties over output tokens. A row with 0 / 0 / 1
    is an exact no-op."""
    pres = samp[:, 4:5]
    freq = samp[:, 5:6]
    rep = torch.where(samp[:, 6:7] <= 0, torch.ones_like(samp[:, 6:7]), samp[:, 6:7])
    lf = logits.float()
    seen = (out_counts > 0) | prompt_mask
    lf = torch.where(seen, torch.where(lf > 0, lf / rep, lf * rep), lf)
    return lf - pres * (out_counts > 0) - freq * out_counts.float()


MAX_TOP_LOGPROBS = 5


def token_logprobs(logits: torch.Tensor, sampled: torch.Tensor, k: int = MAX_TOP_LOGPROBS):
    """(chosen logprob (B,), top-k ids (B, k) int32, top-k logprobs (B, k))
    of each row's log-softmax, for OpenAI ``logprobs``. Taken from the
    post-penalty, post-bias logits before temperature (vLLM semantics):
    temperature and the filters shape sampling only. The normaliser is
    summed in fp64 and each logprob rounded to fp32 once, so the card and
    the CPU, which sum a row in different orders, agree to the last bit
    but for rare ties of rounding."""
    lf = logits.float()
    lse = torch.logsumexp(lf.double(), dim=-1, keepdim=True)
    chosen = lf.gather(-1, sampled[:, None].long()).double()
    top_vals, top_ids = torch.topk(lf, k, dim=-1)
    return (chosen - lse)[:, 0].float(), top_ids.to(torch.int32), (top_vals.double() - lse).float()
