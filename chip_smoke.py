"""Smoke run of ultravox_torch on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel of the port from ultravox_torch/ops/kernels/csrc
     (one nvcc per source, all seven at once);
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the flagship paths give it (bf16; the decode and paged kernels
     also in fp32, with ragged lengths, windows, page size 16, shuffled page
     ids, sentinel entries, a pageless row, and junk in every slot a row
     cannot see), and time kernel, plain version and, where one exists, a
     single PyTorch call for the same function (a yardstick only; the port
     never calls it);
  3. small configs (a llama-family speech model and a gemma-3-style decoder
     with sliding windows): greedy tokens from the kernel paths on the card
     equal those of the plain paths on the CPU (fp32) for generate with the
     decode kernel, generate_fused, the segmented scan with its kernel, and
     the ServingEngine in slots and paged modes with both block attentions;
  4. the main paths at flagship widths (whisper-small encoder, Llama-3.2-1B
     decoder, random bf16 weights from a seed) on 4 requests of 10 s
     synthesized audio, each with every kernel's launch count set to 0
     just before it and checked just after:
       generate(decode_attn_impl="kernel")   12/12/12/16 + 496 decode_attention
       generate_fused (plain merged attention) 12/12/12/16
       prefill + segmented_decode_scan(attn_impl="kernel")
                                               12/12/12/16 + 496 segment_tail_attention
     then breaks the time of generate and generate_fused down by phase and,
     through torch.profiler, by kernel;
  5. the ServingEngine at flagship widths: 8 greedy requests (10 s of audio
     in a 128-token prompt, 32 tokens each) on 4 slots, in three engines
     run in turn: paged with the segment kernel in decode blocks
     (paged_decode_attention + paged_segment_tail_attention), paged with the
     gathered view (paged_decode_attention + gather_pages), and slots with
     the segment kernel (decode_attention + segment_tail_attention). The
     launch counts are checked against the engine's own counters, and TTFT,
     throughput, the loop's dispatch and fetch time, peak memory and (for
     the first) the device's busy share are printed.

Prints the card's name and power limit, one JSON line with the kernels'
numbers, and as its last line {"ok": true, "device": {...}}. Exits non-zero
without a result when there is no CUDA card or the package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
SEED = 0


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """Mean ms per call between CUDA events. ``queued``: the card first
    sleeps while the host enqueues every call, so the events time the
    card's work alone; without it the time includes the host's dispatch
    whenever that is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, kernel: str, iters: int = 20):
    """From a torch.profiler trace of ``iters`` calls of fn: (device ms per
    launch of the device kernel named ``kernel``, its launches per call,
    names of any other device work fn queued). The trace may drop events,
    so the time is the mean over the launches it did record, and the count
    may come out below 1; it never invents a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    mine = [e for e in evs if kernel in e.key]
    others = [e.key for e in evs if kernel not in e.key]
    n = sum(e.count for e in mine)
    ms = sum(e.self_device_time_total for e in mine) / n / 1e3 if n else None
    return ms, n / iters, others


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes: int, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flagship_config(tc):
    """whisper-small encoder + Llama-3.2-1B decoder widths, as the JAX
    package's flagship (its __graft_entry__._flagship_config)."""
    return tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(
            num_mel_bins=80, d_model=768, num_layers=12, num_heads=12,
            ffn_dim=3072, max_source_positions=1500,
        ),
        text_config=tc.DecoderConfig(
            arch="llama", vocab_size=128256, hidden_size=2048,
            intermediate_size=8192, num_layers=16, num_heads=32,
            num_kv_heads=8, head_dim=64, rope_theta=500000.0,
            rms_norm_eps=1e-5, tie_word_embeddings=True,
            max_position_embeddings=8192,
        ),
        hidden_size=3072,
        projector_ln_mid=True,
    )


def _audio(n: int, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """(n, samples) chirp + harmonics + noise at 16 kHz."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    out = []
    for i in range(n):
        f0 = 120.0 + 40.0 * i
        chirp = 0.3 * np.sin(2 * np.pi * (f0 + 150.0 * t) * t)
        harm = sum(0.1 / h * np.sin(2 * np.pi * h * f0 * t) for h in (2, 3, 4))
        out.append(chirp + harm + 0.01 * rng.standard_normal(t.size))
    return np.stack(out).astype(np.float32)


def _batch(cfg, mel: torch.Tensor, prompt_len: int, rng: np.random.Generator):
    """Collated batch: each row's audio spliced at position 4 of the prompt."""
    from ultravox_torch.models.projector import num_audio_tokens

    n = mel.shape[0]
    mel_len = mel.shape[-1]
    ntok = num_audio_tokens(mel_len, cfg.audio_token_compression)
    ids = rng.integers(1, cfg.vocab_size, (n, prompt_len)).astype(np.int64)
    return {
        "input_ids": ids,
        "attention_mask": np.ones((n, prompt_len), np.int64),
        "audio_values": mel.cpu().numpy(),
        "audio_lens": np.full((n,), mel_len, np.int32),
        "audio_token_len": np.full((n,), ntok, np.int32),
        "audio_token_start_idx": np.full((n,), 4, np.int32),
        "audio_chunk_batch_idx": np.arange(n, dtype=np.int32),
    }


def _bf16_tol(ref) -> float:
    """The kernels sum in another order than the plain versions, so bf16
    outputs may differ by a few units in the last place (2^-8 relative):
    4 ulps of the largest output, with no absolute floor."""
    return 4 * 2.0**-8 * float(ref.abs().max())


def _recorder(rows, tol):
    """record(...): hold one kernel against its plain version, time kernel,
    plain version and library call, check the trace, append its row."""

    def record(name, kernel, source, replaces, out, ref, k_fn, p_fn, lib_fn, nbytes, flops, peak):
        err = float((out.float() - ref.float()).abs().max())
        t = tol(ref)
        bound_ms, bound_by = _bound(nbytes, flops, peak)
        device_ms, per_call, others = _device_ms(k_fn, kernel)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "tol": t,
            "ms": _time_ms(k_fn), "plain_ms": _time_ms(p_fn),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _time_ms(lib_fn) if lib_fn is not None else None,
            "device_ms": device_ms, "device_kernels_per_call": per_call,
            "wrapper_ms": _time_ms(k_fn, queued=False),
        }
        print(f"kernel {name}: max_abs_err {err:.3g} (tol {t:.3g}) ms {row['ms']:.4f} "
              f"(trace {device_ms} in {per_call:g} kernels/call; with host dispatch "
              f"{row['wrapper_ms']:.4f}) plain_ms {row['plain_ms']:.4f} "
              f"library_ms {row['library_ms']} bound_ms {bound_ms:.5f} ({bound_by})", flush=True)
        if not err <= t:
            _fail(f"{name} disagrees with its plain version: {err} > {t}")
        # the wrapper must queue its kernel and nothing else (no casts or
        # copies); a trace that dropped events can only undercount
        if per_call > 1 or others:
            _fail(f"{name}: the trace shows {per_call:g} {kernel} launches per call "
                  f"and other device work {sorted(set(others))}, expected 1 and none")
        rows.append(row)

    return record


def _check_kernels(fa, ln_mod, dev):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    B, T, D, H, Dh = 4, 500, 768, 12, 64  # 10 s audio: 1000 mel frames -> 500
    rows = []
    record = _recorder(rows, _bf16_tol)

    # 1. LayerNorm of the encoder FFN; scale and bias are fp32, as
    # fuse_encoder_inference_params stores them
    x = torch.randn((B, T, D), generator=g, device=dev).to(bf)
    s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
    b = 0.1 * torch.randn((D,), generator=g, device=dev)
    s_bf, b_bf = s.to(bf), b.to(bf)
    out = ln_mod.fused_layer_norm(x, s, b)
    ref = ln_mod.layer_norm_plain(x, s, b)
    torch.cuda.synchronize()
    record(
        "fused_layer_norm", "layer_norm_kernel", "ultravox_torch/ops/kernels/csrc/layer_norm.cu",
        "ultravox_tpu/ops/pallas/layer_norm.py:38", out, ref,
        lambda: ln_mod.fused_layer_norm(x, s, b),
        lambda: ln_mod.layer_norm_plain(x, s, b),
        lambda: F.layer_norm(x, (D,), s_bf, b_bf, 1e-5),
        _nbytes(x, s, b, out), 8.0 * x.numel(), FP32_FLOPS,
    )

    # 2. LN -> qkv -> head-major
    C = 3 * D
    w = (0.02 * torch.randn((D, C), generator=g, device=dev)).to(bf)
    wb = (0.02 * torch.randn((C,), generator=g, device=dev)).to(bf)
    out = fa.ln_qkv_head_fused(x, s, b, w, wb, Dh)
    ref = fa.ln_qkv_head_plain(x, s, b, w, wb, Dh)
    torch.cuda.synchronize()
    record(
        "ln_qkv_head_fused", "ln_qkv_head_kernel", "ultravox_torch/ops/kernels/csrc/ln_qkv_head.cu",
        "ultravox_tpu/ops/pallas/fused_attention.py:290", out, ref,
        lambda: fa.ln_qkv_head_fused(x, s, b, w, wb, Dh),
        lambda: fa.ln_qkv_head_plain(x, s, b, w, wb, Dh),
        None, _nbytes(x, s, b, w, wb, out), 2.0 * B * T * D * C, BF16_FLOPS,
    )

    # 3. head-major encoder attention (all 500 keys valid at 10 s). Unit
    # normal q/k/v give logits of unit spread, so a wrong scale or mask
    # moves the output by far more than the tolerance.
    qkv_t = torch.randn((B, 3 * H, T, Dh), generator=g, device=dev).to(bf)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    q3, k3, v3 = qkv_t[:, :H], qkv_t[:, H:2 * H], qkv_t[:, 2 * H:]
    att = fa.attention_headmajor(qkv_t, lens, n_heads=H)
    ref = fa.attention_plain(q3, k3, v3, lens, scale=Dh**-0.5)
    torch.cuda.synchronize()
    keymask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    record(
        "attention_headmajor", "attention_kernel", "ultravox_torch/ops/kernels/csrc/attention.cu",
        "ultravox_tpu/ops/pallas/fused_attention.py:493", att, ref,
        lambda: fa.attention_headmajor(qkv_t, lens, n_heads=H),
        lambda: fa.attention_plain(q3, k3, v3, lens, scale=Dh**-0.5),
        lambda: F.scaled_dot_product_attention(q3, k3, v3, attn_mask=keymask),
        _nbytes(qkv_t, lens, att), 4.0 * B * H * T * T * Dh, BF16_FLOPS,
    )

    # 4. causal prefill of a 128-token prompt into a 256-slot cache slab
    Tp, S, Hq, Hkv = 128, 256, 32, 8
    q = torch.randn((B, Tp, Hq, Dh), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(bf)
    plen = torch.full((B,), Tp, dtype=torch.int32, device=dev)
    offs = torch.zeros((B,), dtype=torch.int32, device=dev)
    att = fa.fused_attention(q, k, v, plen, offs, causal=True, scale=Dh**-0.5)
    ref = fa.attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), plen, offs,
        scale=Dh**-0.5, causal=True,
    ).transpose(1, 2)
    torch.cuda.synchronize()
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
    cols = torch.arange(S, device=dev)
    rows_pos = offs[:, None] + torch.arange(Tp, device=dev)[None]
    pmask = (cols[None, None, :] <= rows_pos[:, :, None]) & (cols[None, None, :] < plen[:, None, None])
    pairs = int(pmask.sum())  # visible (query, key) pairs of this run, per head
    # keys any row can see: below both the valid length and the last row's
    # position; the cache slots past them need not be read
    keys = int(torch.minimum(plen, offs + Tp).clamp(max=S).sum())
    kv_bytes = 2 * keys * Hkv * Dh * k.element_size()
    pmask = pmask[:, None]
    record(
        "fused_attention", "attention_kernel", "ultravox_torch/ops/kernels/csrc/attention.cu",
        "ultravox_tpu/ops/pallas/fused_attention.py:124", att, ref,
        lambda: fa.fused_attention(q, k, v, plen, offs, causal=True, scale=Dh**-0.5),
        lambda: fa.attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), plen, offs,
            scale=Dh**-0.5, causal=True),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=pmask),
        _nbytes(q, att, plen, offs) + kv_bytes, 4.0 * Hq * pairs * Dh, BF16_FLOPS,
    )
    return rows


def _check_decode_kernels(da, sa, dev):
    """Phase 2, continued: decode_attention and segment_tail_attention at the
    main path's mid-decode shapes (B=4, 32 q / 8 kv heads, head_dim 64, a
    256-slot cache). Each case runs in bf16 and fp32, with ragged lengths
    and windows, and again with 1e4 in every slot a row cannot see: the
    output must not move, which shows those slots never enter the kernel.
    The main shape is then timed in bf16."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, H, Hkv, D, S = 4, 32, 8, 64, 256
    scale = D**-0.5
    rows = []
    record = _recorder(rows, _bf16_tol)

    def ints(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def junk(a, hidden):
        """A copy of a (..., B, S, Hkv, D) with 1e4 where hidden (B, S) holds."""
        out = a.clone()
        out[..., hidden, :, :] = 1e4
        return out

    def check(name, fn, plain, args, hidden):
        """fn(*args) against plain(*args) in bf16 and fp32, and against itself
        with junk in the hidden slots. hidden: {arg index: (B, S*) bool}."""
        for dtype in (torch.bfloat16, torch.float32):
            a = [x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x for x in args]
            out, ref = fn(*a), plain(*a)
            for i, h in hidden.items():
                a[i] = junk(a[i], h)
            out_j = fn(*a)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            t = _bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5
            print(f"check {name} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {t:.3g}); "
                  f"junk past the lengths moves it {float((out_j.float() - out.float()).abs().max())}",
                  flush=True)
            if not err <= t:
                _fail(f"{name} ({dtype}) disagrees with its plain version: {err} > {t}")
            if not torch.equal(out, out_j):
                _fail(f"{name} ({dtype}) reads slots past the lengths")

    kpos = torch.arange(S, device=dev)

    # 8. decode_attention: one query per row against one layer's cache slab
    q = torch.randn((B, H, D), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    for case, lens, w in (("mid-decode", ints(144, 144, 144, 144), 0),
                          ("ragged", ints(1, 129, 200, 256), 0),
                          ("ragged+window32", ints(1, 129, 200, 256), 32)):
        lo = torch.clamp(lens - w, min=0) if w else torch.zeros_like(lens)
        hidden = (kpos[None] >= lens[:, None]) | (kpos[None] < lo[:, None])
        check(f"decode_attention {case}",
              lambda q, k, v, lens=lens, w=w: da.decode_attention(q, k, v, lens, w, scale=scale),
              lambda q, k, v, lens=lens, w=w: da.decode_attention_plain(q, k, v, lens, w, scale=scale),
              [q, k, v], {1: hidden, 2: hidden})
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    lens = ints(144, 144, 144, 144)
    out = da.decode_attention(qb, kb, vb, lens)
    ref = da.decode_attention_plain(qb, kb, vb, lens, scale=scale)
    torch.cuda.synchronize()
    visible = kpos[None] < lens[:, None]  # (B, S)
    kv_bytes = 2 * int(visible.sum()) * Hkv * D * kb.element_size()
    record(
        "decode_attention", "decode_attention_kernel",
        "ultravox_torch/ops/kernels/csrc/decode_attention.cu",
        "ultravox_tpu/ops/pallas/decode_attention.py:163", out, ref,
        lambda: da.decode_attention(qb, kb, vb, lens),
        lambda: da.decode_attention_plain(qb, kb, vb, lens, scale=scale),
        lambda: F.scaled_dot_product_attention(
            qb[:, :, None], kb.transpose(1, 2), vb.transpose(1, 2),
            attn_mask=visible[:, None, None], enable_gqa=True),
        _nbytes(qb, out, lens) + kv_bytes, 4.0 * H * int(visible.sum()) * D, BF16_FLOPS,
    )

    # 11. segment_tail_attention: the scan's step against layer 7 of a
    # 16-layer stacked cache plus a 31-slot tail
    L, layer, Ts = 16, 7, 31
    kc = torch.randn((L, B, S, Hkv, D), generator=g, device=dev)
    vc = torch.randn((L, B, S, Hkv, D), generator=g, device=dev)
    tk = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    tv = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    tslot = torch.arange(Ts, device=dev)

    def seg_masks(lens, written, T, w):
        """(prompt (B, T, S), tail (B, T, Ts)) visibility, as the kernel's."""
        t = torch.arange(T, device=dev)[None, :, None]
        n, wr = lens[:, None, None], written[:, None, None]
        q_abs = n + wr + t
        ok_p = kpos < n
        ok_t = tslot <= wr + t
        if w:
            ok_p = ok_p & (q_abs - kpos < w)
            ok_t = ok_t & (q_abs - (n + tslot) < w)
        return ok_p, ok_t

    for case, T, lens, written, w in (
        ("scan step", 1, ints(128, 128, 128, 128), ints(15, 15, 15, 15), 0),
        ("T=3 ragged", 3, ints(1, 60, 128, 200), ints(0, 5, 15, 28), 0),
        ("T=3 ragged+window32", 3, ints(1, 60, 128, 200), ints(0, 5, 15, 28), 32),
        ("scan step+window8", 1, ints(128, 128, 128, 128), ints(15, 15, 15, 15), 8),
    ):
        qs = torch.randn((B, T, H, D), generator=g, device=dev)
        ok_p, ok_t = seg_masks(lens, written, T, w)
        check(f"segment_tail_attention {case}",
              lambda q, kc, vc, tk, tv, lens=lens, wr=written, w=w: sa.segment_tail_attention(
                  q, kc, vc, layer, lens, tk, tv, wr, w, scale=scale),
              lambda q, kc, vc, tk, tv, lens=lens, wr=written, w=w: sa.segment_tail_attention_plain(
                  q, kc, vc, layer, lens, tk, tv, wr, w, scale=scale),
              [qs, kc, vc, tk, tv],
              {1: ~ok_p.any(1), 2: ~ok_p.any(1), 3: ~ok_t.any(1), 4: ~ok_t.any(1)})
    qb = torch.randn((B, 1, H, D), generator=g, device=dev).to(torch.bfloat16)
    kcb, vcb, tkb, tvb = (x.to(torch.bfloat16) for x in (kc, vc, tk, tv))
    lens, written = ints(128, 128, 128, 128), ints(15, 15, 15, 15)
    out = sa.segment_tail_attention(qb, kcb, vcb, layer, lens, tkb, tvb, written)
    ref = sa.segment_tail_attention_plain(qb, kcb, vcb, layer, lens, tkb, tvb, written, scale=scale)
    torch.cuda.synchronize()
    ok_p, ok_t = seg_masks(lens, written, 1, 0)
    keys = int(ok_p.any(1).sum() + ok_t.any(1).sum())  # slots any query of a row sees
    pairs = int(ok_p.sum() + ok_t.sum())  # visible (query, key) pairs, per head
    k_cat = torch.cat([kcb[layer], tkb], dim=1).transpose(1, 2)
    v_cat = torch.cat([vcb[layer], tvb], dim=1).transpose(1, 2)
    mask = torch.cat([ok_p, ok_t], dim=-1)[:, None]
    record(
        "segment_tail_attention", "segment_attention_kernel",
        "ultravox_torch/ops/kernels/csrc/segment_attention.cu",
        "ultravox_tpu/ops/pallas/segment_attention.py:203", out, ref,
        lambda: sa.segment_tail_attention(qb, kcb, vcb, layer, lens, tkb, tvb, written),
        lambda: sa.segment_tail_attention_plain(qb, kcb, vcb, layer, lens, tkb, tvb, written,
                                                scale=scale),
        lambda: F.scaled_dot_product_attention(
            qb.transpose(1, 2), k_cat, v_cat, attn_mask=mask, enable_gqa=True),
        _nbytes(qb, out, lens, written) + 2 * keys * Hkv * D * 2, 4.0 * H * pairs * D, BF16_FLOPS,
    )
    return rows


def _check_paged_kernels(pa, pg, sa, dev):
    """Phase 2, continued: the paged kernels at the shapes the flagship
    paged engine of phase 5 gives them: 4 slots, a pool of 32 pages of 256
    tokens, 16 layers, 8 kv heads of 64, 8 table entries per row, bf16.
    paged_decode_attention and paged_segment_tail_attention run in bf16 and
    fp32 on ragged lengths (up to 1900), windows, page size 16, shuffled
    page ids, sentinel entries and a pageless row of length 1, and again
    with 1e4 in every pool slot (and tail slot) no row can see: the output
    must not move. gather_pages must equal its plain version bit for bit.
    The engine's shapes are then timed in bf16."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    B, H, Hkv, D, L, layer, S = 4, 32, 8, 64, 16, 7, 2048
    scale = D**-0.5
    rows = []
    record = _recorder(rows, _bf16_tol)

    def ints(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def table_of(lens, ps, P, seed):
        """(B, S / ps) int32: ceil(n / ps) shuffled pages per row (none for a
        row of length 1, the pageless inactive slot), sentinel P after."""
        order = np.random.default_rng(seed).permutation(P).tolist()
        table = np.full((B, S // ps), P, np.int32)
        for b, n in enumerate(lens.tolist()):
            for i in range(-(-n // ps) if n > 1 else 0):
                table[b, i] = order.pop()
        return torch.from_numpy(table).to(dev)

    def seen_slots(table, lens, lo, ps, P):
        """(P, ps) bool: pool slots some row reads, keys [lo_b, n_b) through
        the clamped table."""
        seen = torch.zeros((P, ps), dtype=torch.bool, device=dev)
        for b, (n, l0) in enumerate(zip(lens.tolist(), lo)):
            j = torch.arange(max(l0, 0), n, device=dev)
            seen[table[b, j // ps].long().clamp(max=P - 1), j % ps] = True
        return seen

    def check(name, fn, plain, args, junk_at):
        """fn(*args) against plain(*args) in bf16 and fp32, and against
        itself with 1e4 where junk_at {arg index: bool mask} holds."""
        for dtype in (torch.bfloat16, torch.float32):
            a = [x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x for x in args]
            out, ref = fn(*a), plain(*a)
            for i, m in junk_at.items():
                a[i] = a[i].clone()
                a[i][m] = 1e4
            out_j = fn(*a)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            t = _bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5
            print(f"check {name} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {t:.3g}); junk in "
                  f"unseen slots moves it {float((out_j.float() - out.float()).abs().max())}",
                  flush=True)
            if not err <= t:
                _fail(f"{name} ({dtype}) disagrees with its plain version: {err} > {t}")
            if not torch.equal(out, out_j) or not torch.isfinite(out).all():
                _fail(f"{name} ({dtype}) reads slots no row can see")

    engine_lens = ints(129, 150, 171, 190)
    long_lens = ints(1900, 700, 256, 1)
    cases = (  # name, page size, pages, lengths, window
        ("engine", 256, 32, engine_lens, 0),
        ("long+pageless", 256, 32, long_lens, 0),
        ("long+pageless+window100", 256, 32, long_lens, 100),
        ("ps16+window37", 16, 512, ints(1900, 333, 17, 1), 37),
    )

    # 9. paged_decode_attention: one query per row against layer 7's pool
    q = torch.randn((B, H, D), generator=g, device=dev)
    for case, ps, P, lens, w in cases:
        table = table_of(lens, ps, P, SEED)
        kp = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
        vp = torch.randn((P, ps, Hkv, D), generator=g, device=dev)
        lo = [n - w if w else 0 for n in lens.tolist()]
        hide = ~seen_slots(table, lens, lo, ps, P)
        check(f"paged_decode_attention {case}",
              lambda q, k, v, t=table, n=lens, w=w: pa.paged_decode_attention(q, k, v, t, n, w),
              lambda q, k, v, t=table, n=lens, w=w: pa.paged_decode_attention_plain(
                  q, k, v, t, n, w, scale=scale),
              [q, kp, vp], {1: hide, 2: hide})

    # 12. paged_segment_tail_attention: queries at layer 7 of the stacked
    # pool plus an 8-slot tail
    Ts = 8
    tk = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    tv = torch.randn((B, Ts, Hkv, D), generator=g, device=dev)
    for (case, ps, P, lens, w), T, written in zip(
        cases, (1, 3, 3, 1), (ints(0, 3, 5, 7), ints(0, 2, 5, 4), ints(5, 0, 3, 1), ints(7, 0, 3, 1))
    ):
        w = 8 if case.startswith("ps16") else w
        table = table_of(lens, ps, P, SEED + 1)
        kp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev)
        vp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev)
        qs = torch.randn((B, T, H, D), generator=g, device=dev)
        lo = [n + wr - w + 1 if w else 0 for n, wr in zip(lens.tolist(), written.tolist())]
        hide = (~seen_slots(table, lens, lo, ps, P))[None].expand(L, P, ps)
        slot = torch.arange(Ts, device=dev)[None]
        hide_t = slot > (written + T - 1)[:, None]
        if w:
            hide_t |= slot < (written - w + 1)[:, None]
        check(f"paged_segment_tail_attention T={T} {case} window{w}",
              lambda q, k, v, a, b, t=table, n=lens, wr=written, w=w:
                  sa.paged_segment_tail_attention(q, k, v, layer, t, n, a, b, wr, w),
              lambda q, k, v, a, b, t=table, n=lens, wr=written, w=w:
                  sa.paged_segment_tail_attention_plain(q, k, v, layer, t, n, a, b, wr, w,
                                                        scale=scale),
              [qs, kp, vp, tk, tv], {1: hide, 2: hide, 3: hide_t, 4: hide_t})

    # timed at the engine's shapes, bf16
    bf = torch.bfloat16
    P, ps = 32, 256
    table = table_of(engine_lens, ps, P, SEED)
    kp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev).to(bf)
    vp = torch.randn((L, P, ps, Hkv, D), generator=g, device=dev).to(bf)
    qb = q.to(bf)
    keys = int(engine_lens.sum())  # visible keys of all rows
    out = pa.paged_decode_attention(qb, kp[layer], vp[layer], table, engine_lens)
    ref = pa.paged_decode_attention_plain(qb, kp[layer], vp[layer], table, engine_lens, scale=scale)
    torch.cuda.synchronize()
    record(
        "paged_decode_attention", "paged_decode_attention_kernel",
        "ultravox_torch/ops/kernels/csrc/paged_attention.cu",
        "ultravox_tpu/ops/pallas/paged_attention.py:150", out, ref,
        lambda: pa.paged_decode_attention(qb, kp[layer], vp[layer], table, engine_lens),
        lambda: pa.paged_decode_attention_plain(qb, kp[layer], vp[layer], table, engine_lens,
                                                scale=scale),
        None, _nbytes(qb, out, engine_lens, table) + 2 * keys * Hkv * D * 2,
        4.0 * H * keys * D, BF16_FLOPS,
    )

    written = ints(0, 3, 5, 7)
    tkb, tvb = tk.to(bf), tv.to(bf)
    qsb = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    out = sa.paged_segment_tail_attention(qsb, kp, vp, layer, table, engine_lens, tkb, tvb, written)
    ref = sa.paged_segment_tail_attention_plain(qsb, kp, vp, layer, table, engine_lens, tkb, tvb,
                                                written, scale=scale)
    torch.cuda.synchronize()
    keys_t = keys + int((written + 1).sum())  # prompt keys + tail slots 0..written
    record(
        "paged_segment_tail_attention", "paged_segment_attention_kernel",
        "ultravox_torch/ops/kernels/csrc/segment_attention.cu",
        "ultravox_tpu/ops/pallas/segment_attention.py:392", out, ref,
        lambda: sa.paged_segment_tail_attention(qsb, kp, vp, layer, table, engine_lens, tkb, tvb,
                                                written),
        lambda: sa.paged_segment_tail_attention_plain(qsb, kp, vp, layer, table, engine_lens, tkb,
                                                      tvb, written, scale=scale),
        None, _nbytes(qsb, out, engine_lens, written, table) + 2 * keys_t * Hkv * D * 2,
        4.0 * H * keys_t * D, BF16_FLOPS,
    )

    # 10. gather_pages: the whole pool to the (16, 4, 2048, 8, 64) views a
    # paged block reads (each row owns one page; its 7 sentinel entries copy
    # page P - 1)
    ko, vo = pg.gather_pages(kp, vp, table)
    rk = pa.gather_pages_plain(kp, table)
    rv = pa.gather_pages_plain(vp, table)
    torch.cuda.synchronize()
    if not (torch.equal(ko, rk) and torch.equal(vo, rv)):
        _fail("gather_pages differs from its plain version")
    ids = table.long().clamp(max=P - 1).reshape(-1)
    pages_read = int(torch.unique(ids).numel())
    page_bytes = ps * Hkv * D * 2
    record(
        "gather_pages", "paged_gather_kernel", "ultravox_torch/ops/kernels/csrc/paged_gather.cu",
        "ultravox_tpu/ops/pallas/paged_gather.py:69", ko, rk,
        lambda: pg.gather_pages(kp, vp, table),
        lambda: (pa.gather_pages_plain(kp, table), pa.gather_pages_plain(vp, table)),
        lambda: (torch.index_select(kp, 1, ids), torch.index_select(vp, 1, ids)),
        _nbytes(ko, vo, table) + 2 * L * pages_read * page_bytes, 0.0, BF16_FLOPS,
    )
    return rows


def _scan_tokens(engine, batch, n_steps: int, attn_impl: str) -> torch.Tensor:
    """Greedy (B, n_steps + 1) tokens of the engine's prefill and first
    token, then one segmented_decode_scan of n_steps."""
    from ultravox_torch.inference.engine import _cache_bucket
    from ultravox_torch.models.decoder import segmented_decode_scan

    def greedy(logits):
        return logits.argmax(-1).to(torch.int32)

    tb = {k: torch.as_tensor(v).to(engine.device) for k, v in engine.pad_batch(batch).items()}
    B, T = tb["input_ids"].shape
    with torch.inference_mode():
        cache = engine._ensure_cache(None, B, _cache_bucket(T + n_steps + 1, engine.max_cache_len))
        logits, cache, lens = engine._prefill(tb, cache, 0)
        return segmented_decode_scan(
            engine.params["language_model"], engine.cfg.text_config, cache, lens, greedy(logits),
            n_steps=n_steps, sample_fn=greedy, attn_impl=attn_impl,
        ).cpu()


def _small_parity(tc, uv, TEngine, dev):
    """Phase 3: kernel paths on the card vs plain paths on the CPU, fp32,
    greedy tokens identical. For each config: generate (fused encoder and
    prefill kernels, decode kernel), generate_fused, and the segmented scan
    with the segment kernel on the card against its plain form on the CPU.
    The configs: the llama-family speech model, and a gemma-3-style decoder
    (window 8 on every other layer, qk-norm, post-norms, local rope, final
    softcap) whose local layers send the runtime window into both decode
    kernels."""
    from ultravox_torch.ops.kernels.decode_attention import decode_attention
    from ultravox_torch.ops.kernels.segment_attention import segment_tail_attention
    from ultravox_torch.ops.mel import log_mel_spectrogram_np

    text = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True)
    llama = tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(d_model=128, num_layers=2, num_heads=2, ffn_dim=256),
        text_config=tc.DecoderConfig(**text), hidden_size=256, projector_ln_mid=True,
    )
    gemma = tc.UltravoxConfig(text_config=tc.DecoderConfig(**dict(
        text, arch="gemma3", num_layers=4, sliding_window=8, sliding_window_pattern=2,
        qk_norm=True, use_post_norms=True, scale_embeddings=True, rope_theta=1e6,
        rope_local_base_freq=10000.0, final_logit_softcapping=30.0,
        hidden_act="gelu_pytorch_tanh")), llm_only_training=True)
    rng = np.random.default_rng(SEED)
    mel = torch.from_numpy(np.stack([log_mel_spectrogram_np(a) for a in _audio(2, 1.5, rng)]))
    ids = rng.integers(1, 512, (2, 24)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    # larger weights make greedy tokens vary (the encoder's only 2x: larger
    # attention logits there amplify fp32 summation-order noise)
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 8.0}
    for name, cfg, batch in (("llama", llama, _batch(llama, mel, 32, rng)),
                             ("gemma3", gemma, {"input_ids": ids, "attention_mask": mask})):
        params = uv.init_params(cfg, torch.Generator().manual_seed(SEED))
        params = {k: _scale(v, scale[k]) for k, v in params.items()}
        toks = {}
        for device in ("cpu", dev):
            eng = TEngine(params, cfg, max_cache_len=128, cache_dtype=torch.float32,
                          encoder_attn_impl="fused", prefill_attn_impl="fused",
                          decode_attn_impl="kernel", device=device)
            before = (decode_attention.launches, segment_tail_attention.launches)
            toks[device] = {
                "generate": eng.generate(batch, max_new_tokens=12).token_ids,
                "generate_fused": eng.generate_fused(batch, max_new_tokens=12).token_ids,
                "segmented_decode_scan": _scan_tokens(
                    eng, batch, 11, "xla" if device == "cpu" else "kernel").tolist(),
            }
            if device != "cpu" and not (decode_attention.launches > before[0]
                                        and segment_tail_attention.launches > before[1]):
                _fail(f"small parity {name}: a decode kernel was not launched on the card")
        for path, cpu in toks["cpu"].items():
            print(f"small parity {name} {path}: cpu {cpu} gpu {toks[dev][path]}", flush=True)
            if cpu != toks[dev][path]:
                _fail(f"{name} {path}: greedy tokens on the card differ from the CPU's")
        _small_serving_parity(name, params, cfg, [_row(batch, i) for i in range(2)], dev)


def _row(batch, i: int):
    """Row i of a collated batch as a one-request batch."""
    out = {k: batch[k][i: i + 1] for k in ("input_ids", "attention_mask")}
    if "audio_values" in batch:
        n = batch["audio_chunk_batch_idx"] == i
        out.update({k: batch[k][n] for k in (
            "audio_values", "audio_lens", "audio_token_len", "audio_token_start_idx")})
        out["audio_chunk_batch_idx"] = np.zeros((int(n.sum()),), np.int32)
    return out


def _serve(engine, batches, max_tokens: int):
    """Submit every batch at once; (tokens, finish reason, ttft_s) of each."""
    reqs = [engine.submit(dict(b), max_tokens=max_tokens) for b in batches]
    out = []
    for r in reqs:
        ids, end = [], None
        for ev in engine.stream(r, timeout=600):
            if ev.token_id is None:
                end = ev
                break
            ids.append(ev.token_id)
        out.append((ids, end.finish_reason, end.ttft_s))
    return out


def _check_pages(engine, label: str) -> None:
    """Paged mode: every page owned once or free, and the tables agree."""
    if not engine.paged:
        return
    owned = [p for pages in engine._slot_pages for p in pages]
    ok = (len(owned) + len(engine._free_pages) == engine.num_pages
          and len(set(owned) | set(engine._free_pages)) == engine.num_pages)
    for slot, pages in enumerate(engine._slot_pages):
        ok &= engine._table_np[slot, : len(pages)].tolist() == pages
        ok &= bool((engine._table_np[slot, len(pages):] == engine.num_pages).all())
    if not ok:
        _fail(f"{label}: page accounting broken")


def _small_serving_parity(name, params, cfg, requests, dev):
    """The ServingEngine on the card against the same engine on the CPU,
    fp32, greedy tokens identical, in slots and paged modes (pages of 16, a
    pool smaller than the slots' tokens) with both block attentions. Each
    card run must launch its mode's kernels."""
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.ops.kernels import decode_attention as da
    from ultravox_torch.ops.kernels import paged_attention as pa
    from ultravox_torch.ops.kernels import paged_gather as pg
    from ultravox_torch.ops.kernels import segment_attention as sa

    kernels = {
        ("slots", "xla"): (da.decode_attention,),
        ("slots", "kernel"): (da.decode_attention, sa.segment_tail_attention),
        ("paged", "xla"): (pa.paged_decode_attention, pg.gather_pages),
        ("paged", "kernel"): (pa.paged_decode_attention, sa.paged_segment_tail_attention),
    }
    for (mode, impl), counters in kernels.items():
        toks = {}
        for device in ("cpu", dev):
            before = [c.launches for c in counters]
            srv = ServingEngine(
                params, cfg, num_slots=4, max_seq_len=128, cache_dtype=torch.float32,
                cache_mode=mode, page_size=16, num_pages=20 if mode == "paged" else None,
                prefill_len_buckets=(64, 128), mel_len_buckets=(400,), prefill_chunk_tokens=16,
                decode_block_steps=4, encoder_attn_impl="fused", prefill_attn_impl="fused",
                decode_attn_impl="kernel", block_attn_impl=impl, device=device)
            srv.start()
            try:
                out = _serve(srv, requests, 12)
                _check_pages(srv, f"small serving {name} {mode}/{impl}")
            finally:
                srv.stop()
            toks[device] = [ids for ids, _, _ in out]
            if any(f != "length" for _, f, _ in out):
                _fail(f"small serving {name} {mode}/{impl}: finish reasons {[o[1] for o in out]}")
            if device != "cpu" and not all(c.launches > n for c, n in zip(counters, before)):
                _fail(f"small serving {name} {mode}/{impl}: a kernel of the mode was not launched")
        print(f"small serving {name} {mode}/{impl}: cpu {toks['cpu']} gpu {toks[dev]}", flush=True)
        if toks["cpu"] != toks[dev]:
            _fail(f"small serving {name} {mode}/{impl}: greedy tokens on the card differ from the CPU's")


def _scale(tree, f):
    if isinstance(tree, dict):
        return {k: _scale(v, f) for k, v in tree.items()}
    return tree * f if tree.ndim >= 2 else tree


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ultravox_torch.inference.engine import GenerationEngine
    from ultravox_torch.models import config as tc
    from ultravox_torch.models import ultravox as uv
    from ultravox_torch.ops.kernels import _build
    from ultravox_torch.ops.kernels import decode_attention as da
    from ultravox_torch.ops.kernels import fused_attention as fa
    from ultravox_torch.ops.kernels import layer_norm as ln_mod
    from ultravox_torch.ops.kernels import paged_attention as pa
    from ultravox_torch.ops.kernels import paged_gather as pg
    from ultravox_torch.ops.kernels import segment_attention as sa
    from ultravox_torch.ops.mel import log_mel_spectrogram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s total", flush=True)
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.2f} s", flush=True)
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # 2. kernels against their plain versions
    rows = (_check_kernels(fa, ln_mod, dev) + _check_decode_kernels(da, sa, dev)
            + _check_paged_kernels(pa, pg, sa, dev))

    # 3. small end-to-end parity
    _small_parity(tc, uv, GenerationEngine, dev)

    # 4. main path at flagship widths
    cfg = _flagship_config(tc)
    t0 = time.perf_counter()
    params = uv.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16, dev)
    engine = GenerationEngine(
        params, cfg, max_cache_len=1024, encoder_attn_impl="fused",
        prefill_attn_impl="fused", decode_attn_impl="kernel", device=dev,
    )
    del params
    torch.cuda.synchronize()
    wbytes = sum(_nbytes(t) for t in _leaves(engine.params))
    print(f"weights: {wbytes / 1e9:.3f} GB bf16, init {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(SEED)
    n_req, seconds, prompt_len, new_tokens = 4, 10.0, 128, 32
    steps = new_tokens - 1
    wav = torch.from_numpy(_audio(n_req, seconds, rng)).to(dev)
    mel = log_mel_spectrogram(wav)  # (4, 80, 1000) on the card
    batch = _batch(cfg, mel, prompt_len, rng)
    # warm-up: library handles, allocator, every path once
    engine.generate(batch, max_new_tokens=2)
    engine.generate_fused(batch, max_new_tokens=2)
    _scan_tokens(engine, batch, 1, "kernel")

    counters = {
        "fused_layer_norm": ln_mod.fused_layer_norm,
        "ln_qkv_head_fused": fa.ln_qkv_head_fused,
        "attention_headmajor": fa.attention_headmajor,
        "fused_attention": fa.fused_attention,
        "decode_attention": da.decode_attention,
        "segment_tail_attention": sa.segment_tail_attention,
    }
    L_enc, L_dec = cfg.audio_config.num_layers, cfg.text_config.num_layers
    prefill = {
        "fused_layer_norm": L_enc, "ln_qkv_head_fused": L_enc,
        "attention_headmajor": L_enc, "fused_attention": L_dec,
    }

    def run(label, fn, expected):
        """fn() with every count set to 0 just before and read just after."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {name: c.launches for name, c in counters.items()}
        want = {name: expected.get(name, 0) for name in counters}
        print(f"launches, {label}: {launches} expected {want}", flush=True)
        for name, n in launches.items():
            if n != want[name]:
                _fail(f"{name} launched {n} times in {label}, expected {want[name]}")
        return out, t_start, t_end, launches

    def check_tokens(label, ids):
        if len(ids) != n_req or any(len(r) != new_tokens for r in ids):
            _fail(f"{label}: expected {n_req} x {new_tokens} tokens, got {[len(r) for r in ids]}")
        if any(not 0 <= t < cfg.vocab_size for r in ids for t in r):
            _fail(f"{label}: token id out of range")

    # 4.1 generate, decode through the decode_attention kernel
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    result, t_start, t_end, launches = run(
        "generate(decode_attn_impl='kernel')",
        lambda: engine.generate(
            batch, max_new_tokens=new_tokens,
            token_callback=lambda step, toks, done: stamps.append(time.perf_counter())),
        dict(prefill, decode_attention=L_dec * steps),
    )
    ids = result.token_ids
    check_tokens("generate", ids)
    ttft_ms = (stamps[0] - t_start) * 1e3
    decode_tps = n_req * steps / (stamps[-1] - stamps[0])
    print(f"main path: {n_req} requests x {seconds:.0f} s audio, prompt {prompt_len}, "
          f"{new_tokens} greedy tokens; TTFT {ttft_ms:.3f} ms; decode {decode_tps:.2f} tok/s; "
          f"total {(t_end - t_start) * 1e3:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)

    # 4.2 generate_fused: one segmented scan with the plain merged attention,
    # as the JAX engine's generate_fused runs it
    fused, f_start, f_end, _ = run(
        "generate_fused", lambda: engine.generate_fused(batch, max_new_tokens=new_tokens), prefill)
    check_tokens("generate_fused", fused.token_ids)
    fused_ttft_ms = _first_token_ms(engine, batch)
    fused_tps = n_req * steps / ((f_end - f_start) - fused_ttft_ms / 1e3)
    print(f"generate_fused: total {(f_end - f_start) * 1e3:.3f} ms; prefill to first token "
          f"{fused_ttft_ms:.3f} ms (timed apart); decode {fused_tps:.2f} tok/s", flush=True)

    # 4.3 the segmented scan through the segment_tail_attention kernel
    seg, s_start, s_end, seg_launches = run(
        "segmented_decode_scan(attn_impl='kernel')",
        lambda: _scan_tokens(engine, batch, steps, "kernel"),
        dict(prefill, segment_tail_attention=L_dec * steps),
    )
    seg = seg.tolist()[:n_req]
    check_tokens("segmented scan", seg)
    seg_tps = n_req * steps / ((s_end - s_start) - fused_ttft_ms / 1e3)
    print(f"segmented scan (kernel): total {(s_end - s_start) * 1e3:.3f} ms; decode "
          f"{seg_tps:.2f} tok/s (prefill to first token as in generate_fused)", flush=True)
    for row in rows:
        if row["name"] in launches:
            row["launches"] = (seg_launches if row["name"] == "segment_tail_attention"
                               else launches)[row["name"]]
    paths = {"generate": ids, "generate_fused": fused.token_ids, "segmented scan": seg}
    for name, toks in paths.items():
        same = sum(a == b for r, s_ in zip(toks, ids) for a, b in zip(r, s_))
        print(f"first tokens, {name}: {[r[:8] for r in toks]} ({same} of "
              f"{n_req * new_tokens} equal to generate's)", flush=True)
    if len({tuple(r[0] for r in toks) for toks in paths.values()}) != 1:
        _fail("the first token differs between paths that share one prefill")

    _breakdown(engine, batch, new_tokens, {
        "generate": (t_end - t_start) * 1e3, "generate_fused": (f_end - f_start) * 1e3})

    # 5. the ServingEngine at flagship widths, on the same weights
    counters.update({
        "paged_decode_attention": pa.paged_decode_attention,
        "paged_segment_tail_attention": sa.paged_segment_tail_attention,
        "gather_pages": pg.gather_pages,
    })
    serving, serve_launches = _serving_main_path(engine, cfg, counters, prefill, dev)
    for row in rows:
        if row["name"] in serve_launches:
            row["launches"] = serve_launches[row["name"]]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({
        "kernels": rows, "ttft_ms": ttft_ms, "decode_tok_s": decode_tps,
        "fused_first_token_ms": fused_ttft_ms, "fused_decode_tok_s": fused_tps,
        "scan_kernel_decode_tok_s": seg_tps, "serving": serving,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def _serving_main_path(engine, cfg, counters, per_call, dev):
    """Phase 5: the ServingEngine at flagship widths on the weights of
    phase 4's engine. 8 greedy requests (10 s of audio spliced into a
    128-token prompt, 32 tokens each) on 4 slots: the first four prefill in
    two 64-token chunks each while the others wait (single decode steps),
    then 8-step blocks run in steady state. Three engines in turn, each
    warmed up on two other prompts, then with every launch count set to 0
    just before its 8 requests and checked just after against its own
    counters:

        blocks  = (decode steps - decode dispatches) / 7
        singles = dispatches - blocks
        single-step kernel = 16 x singles, block kernel = 16 x 8 x blocks,
        gather_pages = blocks (paged, gathered view),
        fused_attention = 16 x prefill chunks,
        each encoder kernel = its per-call count of phase 4 x admissions.

    Returns (metrics per engine, launches of the new kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import inspect

    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.ops.mel import log_mel_spectrogram

    n_req, seconds, prompt_len, new_tokens, K = 8, 10.0, 128, 32, 8
    L_dec = cfg.text_config.num_layers
    rng = np.random.default_rng(SEED + 5)
    mel = log_mel_spectrogram(torch.from_numpy(_audio(n_req, seconds, rng)).to(dev))
    batch = _batch(cfg, mel, prompt_len, rng)
    warm_ids = batch["input_ids"][:2] % (cfg.vocab_size - 1) + 1  # other prompts: no reuse
    warm = [_row(dict(batch, input_ids=warm_ids), i) for i in range(2)]
    requests = [_row(batch, i) for i in range(n_req)]
    with torch.inference_mode():
        ref = engine.generate(batch, max_new_tokens=new_tokens).token_ids
    fetch = ServingEngine._process_oldest_decode_inner
    lines, first = inspect.getsourcelines(fetch)
    fetch_lines = {(inspect.getsourcefile(fetch), first + i) for i in range(len(lines))}

    engines = (  # label, cache mode, block attention, single-step kernel, block kernel
        ("paged+kernel", "paged", "kernel", "paged_decode_attention", "paged_segment_tail_attention"),
        ("paged+xla", "paged", "xla", "paged_decode_attention", None),
        ("slots+kernel", "slots", "kernel", "decode_attention", "segment_tail_attention"),
    )
    metrics, new_launches, served = {}, {}, {}
    for label, mode, impl, single_k, block_k in engines:
        srv = ServingEngine(
            engine.params, cfg, num_slots=4, max_seq_len=2048, page_size=256, cache_mode=mode,
            prefill_chunk_tokens=64, decode_block_steps=K, encoder_attn_impl="fused",
            prefill_attn_impl="fused", decode_attn_impl="kernel", block_attn_impl=impl, device=dev,
        )
        srv.start()
        try:
            _serve(srv, warm, 12)
            # the same prompts again (now reused from the retained caches)
            # with CUDA sync debugging on: only the loop's fetch may wait
            # (the sleep lets the loop finish the bookkeeping that follows
            # each request's last event)
            sites = _sync_sites(lambda: (_serve(srv, warm, 12), time.sleep(0.5)))
            bad = [site for site in sites if site not in fetch_lines]
            print(f"serving {label}: {len(sites)} host waits for the card, "
                  f"{len(sites) - len(bad)} in the fetch, others at {sorted(set(bad))}", flush=True)
            if bad:
                _fail(f"serving {label}: the loop waits for the card outside its fetch at {bad}")
            for c in counters.values():
                c.launches = 0
            for stat in ("stat_decode_dispatches", "stat_decode_steps", "stat_prefill_chunks"):
                setattr(srv, stat, 0)
            srv.stat_fetch_wait_s = srv.stat_dispatch_s = 0.0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = _serve(srv, requests, new_tokens)
            wall = time.perf_counter() - t0
            launches = {name: c.launches for name, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 1e9
            disp, steps, chunks = (srv.stat_decode_dispatches, srv.stat_decode_steps,
                                   srv.stat_prefill_chunks)
            dispatch_s, fetch_s = srv.stat_dispatch_s, srv.stat_fetch_wait_s
            _check_pages(srv, label)
            busy = None
            if label == "paged+kernel":
                # a second, traced run of other prompts: the device's busy share
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    _serve(srv, [_row(dict(batch, input_ids=batch["input_ids"][::-1].copy()), i)
                                 for i in range(n_req)], new_tokens)
                    torch.cuda.synchronize()
                    traced = time.perf_counter() - t1
                evs = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
                busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
                busy = busy_ms / (traced * 1e3)
                print(f"serving {label} profile: device busy {busy_ms:.3f} ms of {traced * 1e3:.3f} "
                      f"ms traced ({100 * busy:.1f}% busy)", flush=True)
                for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
                    print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
                          f"{e.key[:90]}", flush=True)
        finally:
            srv.stop()
        del srv
        torch.cuda.empty_cache()

        if (steps - disp) % (K - 1):
            _fail(f"serving {label}: {steps} steps in {disp} dispatches is no mix of 1 and {K}")
        blocks = (steps - disp) // (K - 1)
        singles = disp - blocks
        want = {name: 0 for name in counters}
        want.update({name: per_call[name] * n_req for name in
                     ("fused_layer_norm", "ln_qkv_head_fused", "attention_headmajor")})
        want["fused_attention"] = L_dec * chunks
        want[single_k] = L_dec * singles
        if block_k is not None:
            want[block_k] = L_dec * K * blocks
        else:
            want["gather_pages"] = blocks
        print(f"serving {label}: {disp} decode dispatches ({singles} single steps, {blocks} "
              f"blocks of {K}), {chunks} prefill chunks; launches {launches} expected {want}",
              flush=True)
        for name, n in launches.items():
            if n != want[name]:
                _fail(f"serving {label}: {name} launched {n} times, expected {want[name]}")
        if blocks == 0 or singles == 0:
            _fail(f"serving {label}: expected both single steps and blocks")
        for i, (ids, finish, _) in enumerate(out):
            if finish != "length" or len(ids) != new_tokens:
                _fail(f"serving {label}: request {i} finished {finish!r} with {len(ids)} tokens")
            if any(not 0 <= t < cfg.vocab_size for t in ids):
                _fail(f"serving {label}: token id out of range")
        ttft = sorted(t * 1e3 for _, _, t in out)
        agree = [sum(a == b for a, b in zip(ids, r)) for (ids, _, _), r in zip(out, ref)]
        served[label] = [ids for ids, _, _ in out]
        metrics[label] = {
            "ttft_p50_ms": float(np.median(ttft)), "ttft_max_ms": ttft[-1],
            "output_tok_s": n_req * new_tokens / wall, "wall_ms": wall * 1e3,
            "stat_dispatch_s": dispatch_s, "stat_fetch_wait_s": fetch_s, "peak_memory_gb": peak,
            "decode_dispatches": disp, "single_steps": singles, "blocks": blocks,
            "prefill_chunks": chunks, "device_busy_share": busy,
            "tokens_equal_to_generate": agree,
            "first_tokens_equal_to_generate": sum(ids[0] == r[0] for (ids, _, _), r in zip(out, ref)),
        }
        print(f"serving {label}: {n_req} requests x {new_tokens} tokens in {wall * 1e3:.3f} ms "
              f"({n_req * new_tokens / wall:.2f} tok/s); TTFT p50 {np.median(ttft):.3f} ms, max "
              f"{ttft[-1]:.3f} ms; loop dispatch {dispatch_s * 1e3:.3f} ms, fetch wait "
              f"{fetch_s * 1e3:.3f} ms; peak memory {peak:.3f} GB; tokens equal to generate's "
              f"per request {agree} of {new_tokens} (first tokens "
              f"{metrics[label]['first_tokens_equal_to_generate']} of {n_req})", flush=True)
        for name in (single_k, block_k or "gather_pages"):
            if name in ("paged_decode_attention", "paged_segment_tail_attention", "gather_pages"):
                new_launches.setdefault(name, launches[name])
    for label in ("paged+xla", "slots+kernel"):
        same = sum(a == b for x, y in zip(served[label], served["paged+kernel"])
                   for a, b in zip(x, y))
        print(f"serving {label}: {same} of {n_req * new_tokens} tokens equal to paged+kernel's",
              flush=True)
    return metrics, new_launches


def _sync_sites(fn):
    """Run fn with CUDA sync debugging on: the (file, line) of every
    Python call that made the host wait for the card, on any thread."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [(w.filename, w.lineno) for w in caught if "synchroniz" in str(w.message)]


def _first_token_ms(engine, batch) -> float:
    """Host ms from the batch to the first greedy token on the host:
    upload, audio embed, prefill, LM head, argmax. Mean of 3."""
    from ultravox_torch.inference.engine import _cache_bucket

    B, T = engine.pad_batch(batch)["input_ids"].shape
    times = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb = {k: torch.as_tensor(v).to(engine.device) for k, v in engine.pad_batch(batch).items()}
            cache = engine._ensure_cache(None, B, _cache_bucket(T + 32, engine.max_cache_len))
            logits, _, _ = engine._prefill(tb, cache, 0)
            logits.argmax(-1).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / len(times)


def _breakdown(engine, batch, new_tokens: int, untraced_ms) -> None:
    """Where the main paths' time goes: host-clock times of the phases, then
    one traced generate and one traced generate_fused: the device's busy
    time (against the untraced wall time of the same call), its kernels by
    self time, and what is left of the plain decode's cache copies
    (direct_copy_kernel) and fp32 gemv (gemmSN_NN)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ultravox_torch.models import ultravox as uv

    tb = {k: torch.as_tensor(v).to(engine.device) for k, v in engine.pad_batch(batch).items()}
    B = tb["input_ids"].shape[0]

    def timed(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    with torch.inference_mode():
        enc_ms = timed(lambda: uv.ultravox_embed(
            engine.params, engine.cfg, tb["input_ids"], tb,
            encoder_attn_impl=engine.encoder_attn_impl))
        cache = engine._ensure_cache(None, B, 256)
        prefill_ms = timed(lambda: engine._prefill(tb, cache, 0))
        logits, cache, lens = engine._prefill(tb, cache, 0)
        tok = logits.argmax(-1).to(torch.int32)
        step_ms = timed(lambda: engine._decode(cache, tok, lens), n=20)
    print(f"phases: audio embed (mel->encoder->projector->splice) {enc_ms:.3f} ms; "
          f"prefill incl. audio embed {prefill_ms:.3f} ms; one decode step (decode kernel) "
          f"{step_ms:.3f} ms", flush=True)

    for label, fn in (
        ("generate", lambda: engine.generate(batch, max_new_tokens=new_tokens)),
        ("generate_fused", lambda: engine.generate_fused(batch, max_new_tokens=new_tokens)),
    ):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (the CPU ops' rows repeat their kernels' time)
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
        wall = untraced_ms[label]
        print(f"profile {label}: device busy {busy_ms:.3f} ms ({wall:.3f} ms untraced wall: "
              f"{100 * busy_ms / wall:.1f}% busy; {traced_ms:.3f} ms traced)", flush=True)
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}",
                  flush=True)
        for name in ("direct_copy_kernel", "gemmSN_NN"):
            mine = [e for e in evs if name in e.key]
            print(f"  {label}: {name} x{sum(e.count for e in mine)}, "
                  f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
