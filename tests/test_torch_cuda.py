"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, and skips without them. This
module imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
Tolerances: fp32 1e-5 absolute (summation order only); bf16 4 ulps of the
largest output (4 * 2^-8 * max|ref|), since a different summation order can
move an output across a bf16 rounding boundary.
"""

import numpy as np
import pytest
import torch

from ultravox_torch.inference import engine as tengine
from ultravox_torch.models import config as tc
from ultravox_torch.models import ultravox as tuv
from ultravox_torch.ops import mel as tmel
from ultravox_torch.models import decoder as tdec
from ultravox_torch.ops.kernels import decode_attention as tda
from ultravox_torch.ops.kernels import fused_attention as tfa
from ultravox_torch.ops.kernels import layer_norm as tln
from ultravox_torch.ops.kernels import paged_attention as tpa
from ultravox_torch.ops.kernels import paged_gather as tpg
from ultravox_torch.ops.kernels import segment_attention as tsa
from ultravox_torch.inference.serving import engine as tserve

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on the card)")
    return torch.device("cuda")


def _audio_batch(compression: int):
    """Two requests of synthetic audio (1.5 s, 1.0 s) spliced at position 4
    of 32-token prompts. Self-contained: this module runs where the rest of
    tests/ cannot be imported."""
    rng = np.random.default_rng(0)
    mels = []
    for i, sec in enumerate((1.5, 1.0)):
        t = np.arange(int(sec * 16000)) / 16000
        wav = 0.3 * np.sin(2 * np.pi * (150 + 30 * i + 300 * t) * t)
        mels.append(tmel.log_mel_spectrogram_np(wav + 0.02 * rng.standard_normal(t.size)))
    av = np.zeros((2, 80, mels[0].shape[1]), np.float32)
    for i, m in enumerate(mels):
        av[i, :, : m.shape[1]] = m
    lens = np.array([m.shape[1] for m in mels], np.int32)
    return {
        "input_ids": rng.integers(1, 512, (2, 32)).astype(np.int32),
        "attention_mask": np.ones((2, 32), np.int32),
        "audio_values": av,
        "audio_lens": lens,
        "audio_token_len": (-(-lens // compression)).astype(np.int32),
        "audio_token_start_idx": np.array([4, 4], np.int32),
        "audio_chunk_batch_idx": np.array([0, 1], np.int32),
    }


def _case(name, dev, dtype):
    """(kernel call, plain call) on ragged shapes: no dimension is a tile
    multiple, so the kernels' edge masking is exercised."""
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    if name == "layer_norm":
        x, s, b = r(3, 77, 200), r(200), r(200)
        return (lambda: tln.fused_layer_norm(x, s, b), lambda: tln.layer_norm_plain(x, s, b))
    if name == "ln_qkv_head":
        x, s, b, w, pb = r(2, 77, 96), r(96), r(96), 0.1 * r(96, 192), r(192)
        return (lambda: tfa.ln_qkv_head_fused(x, s, b, w, pb, 32),
                lambda: tfa.ln_qkv_head_plain(x, s, b, w, pb, 32))
    if name == "attention_headmajor":
        qkv, lens = r(2, 6, 77, 64), torch.tensor([50, 77], device=dev)
        return (lambda: tfa.attention_headmajor(qkv, lens, n_heads=2, latency_block=16),
                lambda: tfa.attention_plain(qkv[:, :2], qkv[:, 2:4], qkv[:, 4:], lens,
                                            scale=0.125, latency_block=16))
    if name == "decode_attention":  # ragged lengths 1..S, window 20
        q, k, v = r(3, 8, 128), r(3, 70, 2, 128), r(3, 70, 2, 128)
        lens = torch.tensor([1, 33, 70], dtype=torch.int32, device=dev)
        return (lambda: tda.decode_attention(q, k, v, lens, 20),
                lambda: tda.decode_attention_plain(q, k, v, lens, 20, scale=128**-0.5))
    if name == "segment_tail_attention":  # T=3 at layer 2 of 3, window 40
        q, kc, vc = r(3, 3, 8, 64), r(3, 3, 70, 2, 64), r(3, 3, 70, 2, 64)
        tk, tv = r(3, 37, 2, 64), r(3, 37, 2, 64)
        lens = torch.tensor([1, 33, 70], dtype=torch.int32, device=dev)
        written = torch.tensor([0, 20, 34], dtype=torch.int32, device=dev)
        return (lambda: tsa.segment_tail_attention(q, kc, vc, 2, lens, tk, tv, written, 40),
                lambda: tsa.segment_tail_attention_plain(q, kc, vc, 2, lens, tk, tv, written, 40,
                                                         scale=0.125))
    q, k, v = r(2, 40, 4, 128), r(2, 96, 2, 128), r(2, 96, 2, 128)
    lens, offs = torch.tensor([50, 96], device=dev), torch.tensor([10, 56], device=dev)
    return (lambda: tfa.fused_attention(q, k, v, lens, offs, causal=True),
            lambda: tfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                        lens, offs, scale=128**-0.5, causal=True).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["layer_norm", "ln_qkv_head", "attention_headmajor", "fused_attention",
                                  "decode_attention", "segment_tail_attention"])
def test_kernel_matches_plain(cuda_device, name, dt):
    kernel, plain = _case(name, cuda_device, DTYPES[dt])
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    tol = 1e-5 if dt == "float32" else 4 * 2.0**-8 * float(ref.abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_generate_on_cuda_matches_cpu(cuda_device):
    """Kernel path on the card vs plain path on the CPU, fp32: the same
    greedy tokens, and every kernel of the path launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(d_model=128, num_layers=2, num_heads=2, ffn_dim=256),
        text_config=tc.DecoderConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True,
        ),
        hidden_size=256, projector_ln_mid=True,
    )
    params = tuv.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _audio_batch(cfg.audio_token_compression)
    kw = dict(max_cache_len=128, cache_dtype=torch.float32, encoder_attn_impl="fused",
              prefill_attn_impl="fused")
    counters = (tln.fused_layer_norm, tfa.ln_qkv_head_fused, tfa.attention_headmajor,
                tfa.fused_attention)
    before = [f.launches for f in counters]
    gpu = tengine.GenerationEngine(params, cfg, device=cuda_device, **kw).generate(
        batch, max_new_tokens=12)
    assert all(f.launches > n for f, n in zip(counters, before))
    cpu = tengine.GenerationEngine(params, cfg, device="cpu", **kw).generate(
        batch, max_new_tokens=12)
    assert gpu.token_ids == cpu.token_ids


@pytest.mark.cuda
def test_decode_paths_on_cuda_match_cpu(cuda_device):
    """generate with the decode kernel, generate_fused, and the segmented
    scan with its kernel, on the card, against the plain paths on the CPU,
    fp32: the same greedy tokens, and both decode kernels launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tc.UltravoxConfig(
        text_config=tc.DecoderConfig(
            arch="gemma3", vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=4,
            num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True,
            sliding_window=8, sliding_window_pattern=2, qk_norm=True, use_post_norms=True,
            scale_embeddings=True, rope_local_base_freq=10000.0, final_logit_softcapping=30.0,
            hidden_act="gelu_pytorch_tanh",
        ),
        llm_only_training=True,
    )
    params = tuv.init_params(cfg, torch.Generator().manual_seed(0))
    ids = np.random.default_rng(0).integers(1, 512, (2, 24)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    kw = dict(max_cache_len=128, cache_dtype=torch.float32, decode_attn_impl="kernel")

    def greedy(logits):
        return logits.argmax(-1).to(torch.int32)

    def paths(device, scan_impl):
        eng = tengine.GenerationEngine(params, cfg, device=device, **kw)
        tb = {k: torch.as_tensor(v).to(eng.device) for k, v in batch.items()}
        logits, cache, lens = eng._prefill(tb, eng._ensure_cache(None, 2, 128), 0)
        scan = tdec.segmented_decode_scan(
            eng.params["language_model"], cfg.text_config, cache, lens, greedy(logits),
            n_steps=11, sample_fn=greedy, attn_impl=scan_impl)
        return (eng.generate(batch, max_new_tokens=12).token_ids,
                eng.generate_fused(batch, max_new_tokens=12).token_ids, scan.cpu().tolist())

    before = (tda.decode_attention.launches, tsa.segment_tail_attention.launches)
    gpu = paths(cuda_device, "kernel")
    assert tda.decode_attention.launches > before[0]
    assert tsa.segment_tail_attention.launches > before[1]
    assert gpu == paths("cpu", "xla")


def _paged_case(dev, dtype):
    """A 2-layer pool of 12 pages of 16 tokens: shuffled ids, rows with 1, 3
    and 5 pages, sentinel entries (12) after them, and a pageless row of
    length 1. Returns tensors and a (P, ps) mask per layer of the pool slots
    no row can see (window 0), which may hold anything."""
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    L, P, ps, Hkv, D, n_per = 2, 12, 16, 2, 64, 5
    kp, vp = r(L, P, ps, Hkv, D), r(L, P, ps, Hkv, D)
    order = np.random.default_rng(2).permutation(P).tolist()
    table = np.full((4, n_per), P, np.int32)
    for b, used in enumerate((1, 3, 5, 0)):
        for i in range(used):
            table[b, i] = order.pop()
    lens = [9, 40, 77, 1]
    seen = np.zeros((P, ps), bool)
    for b, n in enumerate(lens):
        for j in range(n):
            seen[min(table[b, j // ps], P - 1), j % ps] = True
    return (kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), torch.from_numpy(~seen).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("window", [0, 20])
def test_paged_kernels_match_plain_and_skip_hidden_slots(cuda_device, dt, window):
    """paged_decode_attention and paged_segment_tail_attention (T=2, layer
    1) against their plain versions; with window 0, 1e4 in every pool slot
    no row can see (and in every unwritten tail slot) moves no output."""
    dtype = DTYPES[dt]
    kp, vp, table, lens, hidden = _paged_case(cuda_device, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((4, 8, 64), generator=g, device=cuda_device).to(dtype)
    qs = torch.randn((4, 2, 8, 64), generator=g, device=cuda_device).to(dtype)
    tk, tv = (torch.randn((4, 6, 2, 64), generator=g, device=cuda_device).to(dtype) for _ in range(2))
    written = torch.tensor([0, 2, 4, 1], dtype=torch.int32, device=cuda_device)
    runs = {
        "decode": (lambda k, v, tk, tv: tpa.paged_decode_attention(q, k[1], v[1], table, lens, window),
                   lambda k, v, tk, tv: tpa.paged_decode_attention_plain(
                       q, k[1], v[1], table, lens, window, scale=0.125)),
        "segment": (lambda k, v, tk, tv: tsa.paged_segment_tail_attention(
                        qs, k, v, 1, table, lens, tk, tv, written, window),
                    lambda k, v, tk, tv: tsa.paged_segment_tail_attention_plain(
                        qs, k, v, 1, table, lens, tk, tv, written, window, scale=0.125)),
    }
    jk, jv, jtk, jtv = kp.clone(), vp.clone(), tk.clone(), tv.clone()
    jk[:, hidden], jv[:, hidden] = 1e4, 1e4
    for b, w in enumerate(written.tolist()):
        jtk[b, w + 2:], jtv[b, w + 2:] = 1e4, 1e4  # past the last query's slot
    for name, (kernel, plain) in runs.items():
        out, ref = kernel(kp, vp, tk, tv), plain(kp, vp, tk, tv)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        tol = 1e-5 if dt == "float32" else 4 * 2.0**-8 * float(ref.abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= tol, name
        if window == 0:
            assert torch.equal(kernel(jk, jv, jtk, jtv), out), name


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_gather_pages_is_bit_equal(cuda_device, dt):
    kp, vp, table, _, _ = _paged_case(cuda_device, DTYPES[dt])
    before = tpg.gather_pages.launches
    k, v = tpg.gather_pages(kp, vp, table)
    torch.cuda.synchronize()
    assert tpg.gather_pages.launches == before + 1
    assert torch.equal(k, tpa.gather_pages_plain(kp, table))
    assert torch.equal(v, tpa.gather_pages_plain(vp, table))
    bad = torch.zeros((1, 4, 1, 1, 3), dtype=DTYPES[dt], device=cuda_device)  # 6- or 12-byte pages
    with pytest.raises(ValueError, match="16-byte"):
        tpg.gather_pages(bad, bad, table)


@pytest.mark.cuda
def test_serving_engine_on_cuda_matches_cpu(cuda_device):
    """Slots and paged modes with both block attentions, fp32: the card's
    greedy tokens equal the CPU's, and each mode launched its kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tc.UltravoxConfig(
        text_config=tc.DecoderConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=64, tie_word_embeddings=True,
        ),
        llm_only_training=True,
    )

    def scaled(tree):  # larger weights make greedy tokens vary
        if isinstance(tree, dict):
            return {k: scaled(v) for k, v in tree.items()}
        return tree * 8 if tree.ndim >= 2 else tree

    params = scaled(tuv.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, (1, n)).astype(np.int32) for n in (20, 33, 9)]

    def serve(device, mode, impl):
        eng = tserve.ServingEngine(
            params, cfg, num_slots=4, max_seq_len=128, cache_dtype=torch.float32,
            cache_mode=mode, page_size=16, num_pages=20 if mode == "paged" else None,
            prefill_len_buckets=(64, 128), prefill_chunk_tokens=16, decode_block_steps=4,
            decode_attn_impl="kernel", block_attn_impl=impl, prefill_attn_impl="fused",
            device=device)
        eng.start()
        try:
            reqs = [eng.submit({"input_ids": p, "attention_mask": np.ones_like(p)}, max_tokens=12)
                    for p in prompts]
            out = []
            for r in reqs:
                out.append([ev.token_id for ev in eng.stream(r, timeout=300)])
        finally:
            eng.stop()
        return out

    kernels = {("paged", "kernel"): (tpa.paged_decode_attention, tsa.paged_segment_tail_attention),
               ("paged", "xla"): (tpa.paged_decode_attention, tpg.gather_pages),
               ("slots", "kernel"): (tda.decode_attention, tsa.segment_tail_attention)}
    for (mode, impl), counters in kernels.items():
        before = [c.launches for c in counters]
        gpu = serve(cuda_device, mode, impl)
        assert all(c.launches > n for c, n in zip(counters, before)), (mode, impl)
        assert gpu == serve("cpu", mode, impl), (mode, impl)


# name, T, H, Hkv, lengths (None = no length mask), causal, window, latency
# block. Every mask, GQA 1 and 4, T in {1, 17, 190, 500}; rows of length 0
# and, with the window, padding rows past length + window see no key.
FLASH_CASES = [
    ("plain-T17-gqa1", 17, 4, 4, None, False, 0, 0),
    ("lengths+latency-T500-gqa4", 500, 4, 1, [500, 123, 0], False, 0, 16),
    ("causal+lengths-T190-gqa4", 190, 8, 2, [190, 77, 0], True, 0, 0),
    ("causal+window-T190-gqa4", 190, 4, 1, [190, 50, 1], True, 32, 0),
    ("causal-T1-gqa4", 1, 4, 1, [1, 0], True, 0, 0),
]


def _flash_inputs(dev, dtype, T, H, Hkv, D, lengths, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths) if lengths is not None else 2
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev) if lengths is not None else None
    return r(B, T, H, D), r(B, T, Hkv, D), r(B, T, Hkv, D), r(B, T, H, D), lens


def _flash_run(fn, q, k, v, dout, lens, **kw):
    """(out, dq, dk, dv) of fn's forward and backward under the gradient dout."""
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, lens, **kw)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_matches_plain(cuda_device, case, D, dt):
    """Forward and backward kernels against the plain autograd Function
    (the JAX custom VJP's formulas) on the card: fp32 within 1e-5 (output)
    and 1e-4 (gradients), bf16 within 4 ulps of max|ref|; every output
    finite, rows with no visible key included. A bf16 gradient may also be
    off by 1e-6: at T=1 dq is 0 in exact arithmetic (one key, p = 1, so
    dp = rowsum(do o)) and both versions give fp32 rounding noise."""
    from ultravox_torch.ops.kernels import flash_attention as tfl

    _, T, H, Hkv, lengths, causal, window, lb = case
    dtype = DTYPES[dt]
    q, k, v, dout, lens = _flash_inputs(cuda_device, dtype, T, H, Hkv, D, lengths)
    kw = dict(causal=causal, window=window, latency_block=lb)
    before = (tfl.flash_attention.launches, tfl.flash_attention.bwd_launches)
    got = _flash_run(tfl.flash_attention, q, k, v, dout, lens, **kw)
    assert (tfl.flash_attention.launches, tfl.flash_attention.bwd_launches) == (
        before[0] + 1, before[1] + tfl.BWD_LAUNCHES)
    def plain(q, k, v, lens, causal, window, latency_block):
        return tfl._FlashPlain.apply(q, k, v, lens, D**-0.5, causal, window, latency_block)

    ref = _flash_run(plain, q, k, v, dout, lens, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        if dt == "float32":
            tol = 1e-5 if name == "out" else 1e-4
        else:
            tol = 4 * 2.0**-8 * float(b.abs().max()) + (0.0 if name == "out" else 1e-6)
        assert float((a.float() - b.float()).abs().max()) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_attention_ignores_keys_past_lengths(cuda_device, dt):
    """1e4 in every key and value past each row's length moves neither the
    output nor dq, and the gradient of those keys and values is exactly 0."""
    from ultravox_torch.ops.kernels import flash_attention as tfl

    dtype = DTYPES[dt]
    for T, H, Hkv, lengths, causal, lb in ((500, 4, 1, [500, 123, 7], False, 16),
                                           (190, 8, 2, [190, 77, 3], True, 0)):
        q, k, v, dout, lens = _flash_inputs(cuda_device, dtype, T, H, Hkv, 64, lengths, seed=1)
        past = torch.arange(T, device=cuda_device)[None, :] >= lens[:, None].long()
        jk, jv = k.clone(), v.clone()
        jk[past], jv[past] = 1e4, 1e4
        kw = dict(causal=causal, latency_block=lb)
        out, dq, _, _ = _flash_run(tfl.flash_attention, q, k, v, dout, lens, **kw)
        jout, jdq, jdk, jdv = _flash_run(tfl.flash_attention, q, jk, jv, dout, lens, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, jout) and torch.equal(dq, jdq)
        assert not jdk[past].any() and not jdv[past].any()


@pytest.mark.cuda
def test_flash_attention_raises_on_what_the_kernel_lacks(cuda_device):
    from ultravox_torch.ops.kernels import flash_attention as tfl

    x = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tfl.flash_attention(x, x, x)
    x = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        tfl.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="self-attention"):
        tfl.flash_attention(x, x[:, :4], x[:, :4])
