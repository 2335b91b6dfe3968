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
from ultravox_torch.scripts.compare_kernels import paged_edge_inputs

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


def _small_speech_config():
    """A small llama-family speech model; fp32 products in full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(d_model=128, num_layers=2, num_heads=2, ffn_dim=256),
        text_config=tc.DecoderConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True,
        ),
        hidden_size=256, projector_ln_mid=True,
    )


@pytest.mark.cuda
def test_generate_on_cuda_matches_cpu(cuda_device):
    """Kernel path on the card vs plain path on the CPU, fp32: the same
    greedy tokens, and every kernel of the path launched."""
    cfg = _small_speech_config()
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
# block. Every mask, GQA 1, 2 and 4, T in {1, 17, 64, 65, 128, 190, 500}
# (the bf16 kernels' 64-row tiles: one whole tile, one row past it, two
# tiles, ragged last tiles); rows of length 0 and, with the window, padding
# rows past length + window see no key.
FLASH_CASES = [
    ("plain-T17-gqa1", 17, 4, 4, None, False, 0, 0),
    ("lengths+latency-T500-gqa4", 500, 4, 1, [500, 123, 0], False, 0, 16),
    ("causal+lengths-T190-gqa4", 190, 8, 2, [190, 77, 0], True, 0, 0),
    ("causal+window-T190-gqa4", 190, 4, 1, [190, 50, 1], True, 32, 0),
    ("causal-T1-gqa4", 1, 4, 1, [1, 0], True, 0, 0),
    ("plain-T64-gqa1", 64, 4, 4, None, False, 0, 0),
    ("lengths-T65-gqa2", 65, 4, 2, [65, 64, 1], False, 0, 0),
    ("causal+lengths-T128-gqa4", 128, 8, 2, [128, 100, 63], True, 0, 0),
    ("causal+window+lengths-T500-gqa4", 500, 8, 2, [500, 321, 0], True, 48, 0),
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
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_bf16_is_deterministic(cuda_device, D):
    """The bf16 kernels use no atomics: two runs of forward and backward on
    the same inputs give bit-equal outputs and gradients."""
    from ultravox_torch.ops.kernels import flash_attention as tfl

    q, k, v, dout, lens = _flash_inputs(cuda_device, torch.bfloat16, 190, 8, 2, D,
                                        [190, 77, 0], seed=2)
    kw = dict(causal=True, window=48)
    first = _flash_run(tfl.flash_attention, q, k, v, dout, lens, **kw)
    second = _flash_run(tfl.flash_attention, q, k, v, dout, lens, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# a trace that kept no device event at all is taken again, up to this many
# times (PERF.md section 7: the profiler at times drops every event)
TRACES = 3


def _device_kernel_names(fn, calls=5):
    """Names of the device kernels that ``calls`` runs of fn launched, as a
    trace recorded them (a trace may drop events, so several calls, and up
    to TRACES traces)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if names:
            return names
    return names


@pytest.mark.cuda
def test_flash_attention_routes_fp32_to_cuda_cores_and_bf16_to_mma(cuda_device):
    """fp32 launches the CUDA-core kernels (fp32 on the tensor cores would
    be TF32) and still agrees with the plain version within 1e-5 (output)
    and 1e-4 (gradients); bf16 launches the tensor-core kernels."""
    from ultravox_torch.ops.kernels import flash_attention as tfl

    kw = dict(causal=True)
    for dtype, want, avoid in ((torch.float32, "flash_fwd_kernel", "_mma_kernel"),
                               (torch.bfloat16, "flash_fwd_mma_kernel", "flash_fwd_kernel<")):
        q, k, v, dout, lens = _flash_inputs(cuda_device, dtype, 77, 4, 2, 64, [77, 40], seed=3)
        got = {}
        names = _device_kernel_names(
            lambda: got.__setitem__("r", _flash_run(tfl.flash_attention, q, k, v, dout, lens, **kw)))
        flash = [n[:80] for n in names if "flash_" in n]
        assert any(want in n for n in flash), (dtype, flash, sorted(names)[:8])
        assert not any(avoid in n for n in flash), (dtype, flash)
        if dtype == torch.float32:
            ref = _flash_run(
                lambda *a, **o: tfl._FlashPlain.apply(*a, 64**-0.5, o["causal"], 0, 0),
                q, k, v, dout, lens, **kw)
            for name, a, b in zip(("out", "dq", "dk", "dv"), got["r"], ref):
                tol = 1e-5 if name == "out" else 1e-4
                err = float((a - b).abs().max())
                assert err <= tol, (name, err)


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


# attention_headmajor / fused_attention / the probes in bf16: the tensor-core
# kernel of csrc/attention_mma.cuh. Bounds as flash_attention's: 4 bf16 ulps
# of max|ref| per element and a relative RMS error of 2^-10.
ATTN_RMS_TOL = 2.0**-10


def _attn_close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    err = float((out.float() - ref.float()).abs().max())
    rms = float((out.float() - ref.float()).norm() / ref.float().norm().clamp(min=1e-30))
    assert err <= 4 * 2.0**-8 * float(ref.abs().max()), err
    assert rms <= ATTN_RMS_TOL, rms


def _ints(dev, v):
    return torch.tensor(v, dtype=torch.int32, device=dev) if v is not None else None


# (name, B, Tq, S, H, Hkv, lengths, row offsets, causal, latency block):
# Tq and S at the kernel's tile edges (1, 63, 64, 65, 500), every mask, a
# row of length 0 (it averages v over all S keys), GQA 4, and the serving
# prefill chunk: 64 rows at offsets 65 / 126 against a 2048-slot cache with
# 129 / 190 valid keys
ATTN_CASES = [
    ("plain-T1-S1", 2, 1, 1, 4, 4, None, None, False, 0),
    ("lengths-T63-S63", 2, 63, 63, 4, 4, [63, 20], None, False, 0),
    ("lengths+latency-T64-S64", 2, 64, 64, 4, 4, [64, 33], None, False, 16),
    ("causal-T65-S65-gqa4", 2, 65, 65, 8, 2, None, None, True, 0),
    ("lengths+latency-T500-S500", 3, 500, 500, 4, 4, [500, 311, 1], None, False, 16),
    ("zero-length-row-T65-S500", 2, 65, 500, 4, 2, [0, 500], None, False, 0),
    ("causal+offsets-T63-S500-gqa4", 2, 63, 500, 8, 2, [200, 463], [137, 400], True, 0),
    ("causal+offsets+latency-T1-S64", 3, 1, 64, 4, 1, [64, 40, 1], [63, 39, 0], True, 8),
    ("causal+zero-length-T64-S65", 2, 64, 65, 4, 4, [0, 65], [0, 1], True, 0),
    ("serving-T64-S2048-gqa4", 2, 64, 2048, 32, 8, [129, 190], [65, 126], True, 0),
]


def _attn_inputs(dev, B, Tq, S, H, Hkv, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    return r(B, Tq, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D)


def _fused_plain(q, k, v, lens, offs, causal, lb):
    return tfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lens,
                               offs, scale=q.shape[-1] ** -0.5, causal=causal,
                               latency_block=lb).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_fused_attention_bf16_matches_plain(cuda_device, case, D):
    """fused_attention's (B, T, H, D) queries against (B, S, Hkv, D) keys in
    bf16: the tensor-core kernel against attention_plain."""
    _, B, Tq, S, H, Hkv, lengths, offsets, causal, lb = case
    q, k, v = _attn_inputs(cuda_device, B, Tq, S, H, Hkv, D)
    lens, offs = _ints(cuda_device, lengths), _ints(cuda_device, offsets)
    before = tfa.fused_attention.launches
    out = tfa.fused_attention(q, k, v, lens, offs, causal=causal, latency_block=lb)
    ref = _fused_plain(q, k, v, lens, offs, causal, lb)
    torch.cuda.synchronize()
    assert tfa.fused_attention.launches == before + 1
    _attn_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T,lengths,lb", [(1, [1, 0], 0), (63, [63, 5], 16), (64, [64, 64], 0),
                                          (65, [0, 65], 8), (500, [500, 123], 16)])
def test_attention_headmajor_bf16_matches_plain(cuda_device, T, lengths, lb, D):
    """The packed head-major (B, 3H, T, D) layout, q/k/v read in place at
    head offsets 0, H and 2H, in bf16 against attention_plain."""
    g = torch.Generator(device=cuda_device).manual_seed(T)
    H = 3
    qkv = torch.randn((2, 3 * H, T, D), generator=g, device=cuda_device).to(torch.bfloat16)
    lens = _ints(cuda_device, lengths)
    before = tfa.attention_headmajor.launches
    out = tfa.attention_headmajor(qkv, lens, n_heads=H, latency_block=lb)
    ref = tfa.attention_plain(qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:], lens,
                              scale=D**-0.5, latency_block=lb)
    torch.cuda.synchronize()
    assert tfa.attention_headmajor.launches == before + 1
    _attn_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("exp", ["float32", "bfloat16"])
@pytest.mark.parametrize("probe", ["attn_v2", "attn_nt"])
@pytest.mark.parametrize("T,S,lengths", [(1, 64, [64, 0]), (63, 65, [65, 1]),
                                         (65, 500, [500, 64]), (500, 63, None)])
def test_encoder_attn_probe_bf16_at_tile_edges(cuda_device, T, S, lengths, probe, exp):
    """Both probes, both exponents, bf16 inputs at the kernel's tile edges
    and a row of length 0, against their plain version."""
    from ultravox_torch.ops.kernels import encoder_attn_probe as tprobe

    q, k, v = _attn_inputs(cuda_device, 2, T, S, 3, 3, 64, seed=T + S)
    lens = _ints(cuda_device, lengths)
    fn = getattr(tprobe, probe)
    out = fn(q, k, v, lens, scale=0.125, block_q=T, exp_dtype=DTYPES[exp])
    ref = tprobe.attn_probe_plain(q, k, v, lens, scale=0.125, exp_dtype=DTYPES[exp])
    torch.cuda.synchronize()
    _attn_close(out, ref)


@pytest.mark.cuda
def test_attention_bf16_ignores_cache_slots_past_the_visible_keys(cuda_device):
    """1e4 in every cache slot that no row can see (past each row's
    length, or past the chunk's last row) leaves the output bit for bit:
    the kernel stops at the last visible key, and a hidden key inside the
    last tile it reads gets probability exactly 0. Two runs are bit-equal."""
    q, k, v = _attn_inputs(cuda_device, 2, 64, 2048, 32, 8, 64, seed=5)
    lens, offs = _ints(cuda_device, [129, 190]), _ints(cuda_device, [65, 126])
    out = tfa.fused_attention(q, k, v, lens, offs, causal=True)
    again = tfa.fused_attention(q, k, v, lens, offs, causal=True)
    past = torch.arange(2048, device=cuda_device)[None, :] >= lens[:, None].long()
    jk, jv = k.clone(), v.clone()
    jk[past], jv[past] = 1e4, 1e4
    junk = tfa.fused_attention(q, jk, jv, lens, offs, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, junk)


@pytest.mark.cuda
def test_attention_bf16_is_deterministic_and_routes_to_mma(cuda_device):
    """bf16 launches the tensor-core kernel, fp32 the CUDA-core one; two
    bf16 runs give bit-equal outputs."""
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in _attn_inputs(cuda_device, 2, 190, 190, 8, 2, 64, 3))
        lens = _ints(cuda_device, [190, 77])
        runs = []
        names[dtype] = _device_kernel_names(
            lambda: runs.append(tfa.fused_attention(q, k, v, lens, causal=True)))
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert any("attention_mma_kernel" in n for n in names[torch.bfloat16])
    assert not any("attention_kernel<" in n for n in names[torch.bfloat16])
    assert any("attention_kernel<float" in n for n in names[torch.float32])


@pytest.mark.cuda
def test_attention_bf16_raises_on_misaligned_views(cuda_device):
    """The bf16 kernel copies 16-byte pieces: a view that starts off a
    16-byte boundary, or whose strides are not multiples of 16 bytes,
    raises ValueError (there is no fallback)."""
    from ultravox_torch.ops.kernels import encoder_attn_probe as tprobe

    buf = torch.randn(2 * 8 * 2 * 64 + 1, device=cuda_device).to(torch.bfloat16)
    shifted = buf[1:].view(2, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.fused_attention(shifted, shifted, shifted)
    wide = torch.randn((2, 8, 2, 68), device=cuda_device).to(torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.fused_attention(wide, wide, wide)
    qkv = torch.randn((1, 6, 9, 68), device=cuda_device).to(torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.attention_headmajor(qkv, _ints(cuda_device, [9]), n_heads=2)
    with pytest.raises(ValueError, match="16-byte"):
        tprobe.attn_nt(shifted, shifted, shifted, scale=0.125, block_q=8)
    # fp32 runs on the CUDA cores and takes any stride
    wide32 = torch.randn((2, 8, 2, 68), device=cuda_device)[..., :64]
    out = tfa.fused_attention(wide32, wide32, wide32)
    ref = _fused_plain(wide32, wide32, wide32, None, None, False, 0)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5


# qkv_head_transpose: the flagship encoder's shapes (B 4 and 1, T 500, 36
# heads of 64), a ragged T with head_dim 128, a single frame, a T that the
# plan's 4-row blocks leave a partial last block of (T % 4 == 1 at B 4), and
# heads too wide for one block's shared memory (split into groups in fp32)
QKV_SHAPES = [(4, 500, 36, 64), (1, 500, 36, 64), (2, 77, 6, 128), (1, 1, 36, 64),
              (4, 501, 36, 64), (1, 3, 600, 128)]


def _transpose_check(qkv, Dh):
    """Bit-equal to the plain version, two calls bit-equal, one launch
    each, and only the kernel in a trace."""
    B, T, C = qkv.shape
    before = tfa.qkv_head_transpose.launches
    out = tfa.qkv_head_transpose(qkv, Dh)
    again = tfa.qkv_head_transpose(qkv, Dh)
    ref = tfa.qkv_head_transpose_plain(qkv, Dh)
    torch.cuda.synchronize()
    assert tfa.qkv_head_transpose.launches == before + 2
    assert out.shape == (B, C // Dh, T, Dh) and out.dtype == qkv.dtype
    assert torch.equal(out, ref) and torch.equal(again, ref)
    names = _device_kernel_names(lambda: tfa.qkv_head_transpose(qkv, Dh))
    assert len(names) == 1 and "qkv_head_transpose_kernel" in next(iter(names)), names


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", QKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_qkv_head_transpose_is_bit_equal(cuda_device, shape, dt):
    B, T, G, Dh = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((B, T, G * Dh), generator=g, device=cuda_device).to(DTYPES[dt])
    _transpose_check(qkv, Dh)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("shape,dt", [((1, 500, 36, 64), "bfloat16"), ((2, 77, 6, 128), "float32"),
                                      ((1, 3, 600, 128), "float32")],
                         ids=lambda s: "x".join(map(str, s)) if isinstance(s, tuple) else s)
def test_qkv_head_transpose_every_row_count(cuda_device, shape, dt, rows, monkeypatch):
    """Each block's rows forced in turn: partial last blocks (T % rows), a
    row count past T, and head groups where a block's tile would not fit."""
    import functools

    B, T, G, Dh = shape
    monkeypatch.setattr(tfa, "_transpose_plan", functools.partial(tfa._transpose_plan, rows=rows))
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    qkv = torch.randn((B, T, G * Dh), generator=g, device=cuda_device).to(DTYPES[dt])
    _transpose_check(qkv, Dh)


@pytest.mark.cuda
def test_qkv_head_transpose_raises_on_what_the_kernel_lacks(cuda_device):
    qkv = torch.randn((2, 16, 6 * 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.qkv_head_transpose(qkv.transpose(0, 1), 64)
    with pytest.raises(ValueError, match="head dim"):
        tfa.qkv_head_transpose(qkv, 32)
    with pytest.raises(TypeError):
        tfa.qkv_head_transpose(qkv.half(), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 768, 2304), (40, 2048, 3072), (17, 64, 8)])
def test_int8_product_is_exact_on_the_card(cuda_device, shape):
    """w8a8's int8 x int8 -> int32 product (torch._int_mm) equals the CPU's
    int32 product bit for bit, for a row-major and a column-major weight."""
    from ultravox_torch.models import lora as tlora

    M, K, N = shape
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    ref = tlora.int8_mm(xq, wq)
    for w in (wq.to(cuda_device), wq.t().contiguous().t().to(cuda_device)):
        out = tlora.int8_mm(xq.to(cuda_device), w)
        assert out.dtype == torch.int32 and torch.equal(out.cpu(), ref)
    with pytest.raises(RuntimeError, match="16"):
        tlora.int8_mm(xq[:16].to(cuda_device), wq.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 96])
def test_int8_proj_apply_on_the_card_matches_cpu(cuda_device, rows):
    """proj_apply on an int8 projection in both regimes (w8a16 at 8 rows,
    w8a8 at 96), bf16 activations, against the CPU: w8a8's scales are
    correctly rounded divisions and its accumulators exact, so the outputs
    are bit-equal; w8a16 sums bf16 x int8 products in another order (4
    ulps)."""
    from ultravox_torch.models import decoder as tdec_
    from ultravox_torch.models import lora as tlora

    g = torch.Generator().manual_seed(1)
    w = 0.05 * torch.randn((256, 512), generator=g)
    q, s = tdec_._quantize_kernel(w)
    p = {"kernel_q": q, "scale": s, "bias": 0.1 * torch.randn((512,), generator=g).bfloat16()}
    x = torch.randn((2, rows // 2, 256), generator=g).bfloat16()
    ref = tlora.proj_apply(x, p)
    out = tlora.proj_apply(x.to(cuda_device), {k: v.to(cuda_device) for k, v in p.items()})
    assert out.dtype == torch.bfloat16
    if rows > tlora.W8A16_MAX_ROWS:
        assert torch.equal(out.cpu(), ref)
    else:
        tol = 4 * 2.0**-8 * float(ref.float().abs().max())
        assert float((out.cpu().float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_int8_quantizers_on_the_card_match_cpu(cuda_device):
    """The engines quantize on the card: int8 values and bf16 scales equal
    the CPU's bit for bit, and so do w8a8's activation scales (amax / 127
    as a true division; a Python-number divisor is a reciprocal product on
    the card, an ulp off for about 4% of values)."""
    from ultravox_torch.models import decoder as tdec_
    from ultravox_torch.models import lora as tlora

    g = torch.Generator().manual_seed(3)
    w = 0.05 * torch.randn((2, 768, 2304), generator=g)
    e = torch.randn((1000, 256), generator=g)
    for fn, src in ((tdec_._quantize_kernel, w), (tdec_._quantize_embedding, e)):
        (q, s), (qc, sc) = fn(src), fn(src.to(cuda_device))
        assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
    amax = w.abs().amax(dim=-1, keepdim=True)
    assert torch.equal(tlora.int8_scale(amax.to(cuda_device)).cpu(), tlora.int8_scale(amax))


@pytest.mark.cuda
def test_banked_proj_apply_on_the_card_matches_cpu(cuda_device):
    """A small banked LoRA projection (three rows on adapters 0, 2, 1; fp32)
    on the card against the CPU."""
    from ultravox_torch.models import lora as tlora

    g = torch.Generator().manual_seed(2)
    L, d_in, r, d_out = 2, 48, 4, 40
    trees = {}
    for name in ("a", "b"):
        trees[name] = {"layers": {"q_proj": {
            "lora_a": torch.randn((L, d_in, r), generator=g),
            "lora_b": torch.randn((L, r, d_out), generator=g),
            "lora_scale": torch.full((L,), 2.0),
        }}}
    banks, index = tlora.build_lora_banks(trees)
    base = {"layers": {"q_proj": {"kernel": torch.randn((L, d_in, d_out), generator=g)}}}
    x = torch.randn((3, 5, d_in), generator=g)
    idx = torch.tensor([0, index["b"], index["a"]], dtype=torch.int32)

    def run(dev):
        to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)  # noqa: E731
        tree = tlora.apply_lora_banks(to(base), to(banks), idx.to(dev))
        layer = {k: v[1] for k, v in tree["layers"]["q_proj"].items()}
        return tlora.proj_apply(x.to(dev), layer).cpu()

    assert float((run(cuda_device) - run("cpu")).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_flash_encoder_engines_on_cuda_match_cpu(cuda_device):
    """encoder_attn_impl="flash" in both engines on the card against the CPU,
    fp32: the same greedy tokens, with flash_attention's forward kernel
    launched once per encoder layer per encoder call and no encoder kernel
    of the fused path."""
    from ultravox_torch.ops.kernels import flash_attention as tfl

    cfg = _small_speech_config()
    params = tuv.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _audio_batch(cfg.audio_token_compression)
    fused = (tln.fused_layer_norm, tfa.ln_qkv_head_fused, tfa.attention_headmajor)
    toks = {}
    for device in ("cpu", cuda_device):
        tfl.flash_attention.launches = 0
        before = [f.launches for f in fused]
        eng = tengine.GenerationEngine(params, cfg, max_cache_len=128, cache_dtype=torch.float32,
                                       encoder_attn_impl="flash", device=device)
        gen = eng.generate(batch, max_new_tokens=12).token_ids
        srv = tserve.ServingEngine(
            params, cfg, num_slots=2, max_seq_len=128, cache_dtype=torch.float32,
            cache_mode="paged", page_size=16, prefill_len_buckets=(64, 128),
            mel_len_buckets=(400,), prefill_chunk_tokens=16, encoder_attn_impl="flash",
            device=device)
        srv.start()
        try:
            reqs = [srv.submit({k: v[i: i + 1] if k != "audio_chunk_batch_idx" else v[:1] * 0
                                for k, v in batch.items()}, max_tokens=12) for i in range(2)]
            served = []
            for r in reqs:
                served.append([ev.token_id for ev in srv.stream(r, timeout=300)
                               if ev.token_id is not None])
        finally:
            srv.stop()
        toks[str(device)] = (gen, served)
        if device != "cpu":
            # one generate (one encoder call) and two admissions (one each)
            assert tfl.flash_attention.launches == cfg.audio_config.num_layers * 3
            assert [f.launches for f in fused] == before
    assert toks["cpu"] == toks[str(cuda_device)]


# decode_matmul: (K, N) with a ragged K and an odd N (one column per lane),
# the test_pallas shape, and one that splits K over blocks
DM_SHAPES = [(300, 1001), (256, 1664), (4096, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", list(DTYPES))
@pytest.mark.parametrize("weight", ["bfloat16", "int8"])
@pytest.mark.parametrize("kn", DM_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("M", [1, 4, 32])
def test_decode_matmul_matches_plain(cuda_device, M, kn, weight, xdt):
    from ultravox_torch.ops.kernels import decode_matmul as tdm

    K, N = kn
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((M, K), generator=g, device=cuda_device).to(DTYPES[xdt])
    w = 0.02 * torch.randn((K, N), generator=g, device=cuda_device)
    scale = None
    if weight == "int8":
        scale = (w.abs().amax(dim=0) / 127).to(torch.bfloat16)
        w = torch.round(w / scale.float()).clamp(-127, 127).to(torch.int8)
    else:
        w = w.to(torch.bfloat16)
    for out_dtype in (None, torch.float32):
        before = tdm.decode_matmul.launches
        out = tdm.decode_matmul(x, w, scale, out_dtype=out_dtype)
        ref = tdm.decode_matmul_plain(x, w, scale, out_dtype)
        torch.cuda.synchronize()
        assert tdm.decode_matmul.launches == before + 1
        assert out.shape == (M, N) and out.dtype == ref.dtype
        # fp32: 1e-5 of the largest output, whose sums run over up to 4096 terms
        big = float(ref.abs().max())
        tol = 1e-5 * max(1.0, big) if out.dtype == torch.float32 else 4 * 2.0**-8 * big
        assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_decode_matmul_raises_on_what_the_kernel_lacks(cuda_device):
    from ultravox_torch.ops.kernels import decode_matmul as tdm

    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros((64, 128), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="rows"):
        tdm.decode_matmul(torch.zeros((33, 64), dtype=torch.bfloat16, device=cuda_device), w)
    with pytest.raises(TypeError, match="weight"):
        tdm.decode_matmul(x, w.float())
    with pytest.raises(ValueError, match="contiguous"):
        tdm.decode_matmul(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="scale"):
        tdm.decode_matmul(x, w, torch.ones(64, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        tdm.decode_matmul(x, w.cpu())


# #6 ln_matmul_gelu: (B, T, D, F). The encoder's fc1 at 4 requests and at
# one, a single frame, a ragged shape at D 96, whisper-large's FFN (64-row
# tiles)
GELU_SHAPES = [(4, 500, 768, 3072), (1, 500, 768, 3072), (4, 1, 768, 3072), (2, 77, 96, 384),
               (1, 1500, 1280, 5120)]


def _gelu_inputs(dev, B, T, D, F, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, T, D), generator=g, device=dev).to(dtype)
    s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
    b = 0.1 * torch.randn((D,), generator=g, device=dev)
    w = (0.05 * torch.randn((D, F), generator=g, device=dev)).to(dtype)
    wb = torch.randn((F,), generator=g, device=dev).to(dtype)
    return x, s, b, w, wb


def _gelu_check(x, s, b, w, wb, kernel, tol32=1e-5):
    """Within ``tol32`` (fp32) or 4 bf16 ulps of the plain version, two
    calls bit-equal, one launch each, and only ``kernel`` in a trace."""
    before = tfa.ln_matmul_gelu.launches
    out = tfa.ln_matmul_gelu(x, s, b, w, wb)
    again = tfa.ln_matmul_gelu(x, s, b, w, wb)
    ref = tfa.ln_matmul_gelu_plain(x, s, b, w, wb)
    torch.cuda.synchronize()
    assert tfa.ln_matmul_gelu.launches == before + 2
    assert out.shape == ref.shape and out.dtype == x.dtype
    assert torch.equal(out, again)
    tol = tol32 if x.dtype == torch.float32 else 4 * 2.0**-8 * float(ref.abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol
    names = _device_kernel_names(lambda: tfa.ln_matmul_gelu(x, s, b, w, wb))
    assert len(names) == 1 and f"{kernel}<" in next(iter(names)), names


def _gelu_kernel(dtype):
    return "ln_matmul_gelu_mma_kernel" if dtype == torch.bfloat16 else "ln_matmul_gelu_kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ln_matmul_gelu_matches_plain(cuda_device, dt):
    """A ragged shape: no dimension is a multiple of either tile. bf16 on
    the tensor cores (ln_matmul_gelu_mma_kernel), fp32 on the CUDA cores
    (ln_matmul_gelu_kernel)."""
    dtype = DTYPES[dt]
    x, s, b, w, wb = _gelu_inputs(cuda_device, 2, 77, 96, 200, dtype)
    _gelu_check(x, s, b, w, wb, _gelu_kernel(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", GELU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ln_matmul_gelu_at_encoder_shapes(cuda_device, shape, dt):
    """The encoder's shapes. fp32 within 1e-5 of the largest output: the
    sums of 768-1280 terms of outputs up to ~5 differ from the plain
    version's order by a few fp32 ulps."""
    dtype = DTYPES[dt]
    x, s, b, w, wb = _gelu_inputs(cuda_device, *shape, dtype)
    big = float(tfa.ln_matmul_gelu_plain(x, s, b, w, wb).abs().max())
    _gelu_check(x, s, b, w, wb, _gelu_kernel(dtype), tol32=1e-5 * max(1.0, big))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 2, 3, 5, 64])
@pytest.mark.parametrize("shape", [(2, 77, 96, 384), (3, 61, 656, 1544), (3, 61, 784, 1544),
                                   (1, 1, 768, 3072)], ids=lambda s: "x".join(map(str, s)))
def test_ln_matmul_gelu_every_tile(cuda_device, shape, tiles, monkeypatch):
    """Each tensor-core tile that fits and each count of column tiles a
    block runs, forced in turn, at ragged shapes: rows and columns that no
    tile divides, a last block with fewer column tiles, D 656 and 784 (a
    last weight stage half full; 784 past 3 pieces a lane, where 128 rows
    no longer fit). A tile that does not fit raises before any launch."""
    import functools

    B, T, D, F = shape
    plan = tfa._gelu_plan
    fits = [m for m in tfa.MMA_ROWS if tfa.mma_smem_bytes(m, D) <= tfa.MAX_SMEM]
    assert fits
    for bm in tfa.MMA_ROWS:
        monkeypatch.setattr(tfa, "_gelu_plan", functools.partial(plan, bm=bm, tiles=tiles))
        x, s, b, w, wb = _gelu_inputs(cuda_device, B, T, D, F, torch.bfloat16, seed=bm + tiles)
        if bm in fits:
            _gelu_check(x, s, b, w, wb, "ln_matmul_gelu_mma_kernel")
        else:
            with pytest.raises(ValueError, match="cannot run"):
                tfa.ln_matmul_gelu(x, s, b, w, wb)


@pytest.mark.cuda
def test_ln_matmul_gelu_unaligned_view_takes_the_cuda_cores(cuda_device):
    """A bf16 x one element off its storage cannot take 16-byte copies: the
    plan routes it to the CUDA-core kernel, which still holds 4 ulps."""
    x, s, b, w, wb = _gelu_inputs(cuda_device, 2, 77, 768, 3072, torch.bfloat16)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    xv = base[1:].view(x.shape).copy_(x)
    _gelu_check(xv, s, b, w, wb, "ln_matmul_gelu_kernel")


@pytest.mark.cuda
def test_ln_matmul_gelu_tensor_core_kernels_hold_hmma(cuda_device):
    """cuobjdump's SASS: HMMA in every tensor-core instance, none in the
    fp32 CUDA-core kernel."""
    import os
    import subprocess

    from ultravox_torch.ops.kernels import _build

    path = _build.build_all(["ln_matmul_gelu"])["ln_matmul_gelu"]["path"]
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    hmma = {b.split("\n", 1)[0].strip(): b.count("HMMA") for b in sass.split("Function : ")[1:]}
    mma = [c for n, c in hmma.items() if "ln_matmul_gelu_mma_kernel" in n]
    fp32 = [c for n, c in hmma.items() if "ln_matmul_gelu_kernelIf" in n]
    assert len(mma) == len(tfa.MMA_ROWS) and all(mma), hmma
    assert len(fp32) == 1 and not fp32[0], hmma


@pytest.mark.cuda
def test_ln_matmul_gelu_raises_on_what_the_kernel_lacks(cuda_device):
    x = torch.zeros((1, 8, 64), device=cuda_device)
    s = torch.ones(64, device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        tfa.ln_matmul_gelu(x, s, s, torch.zeros((64, 32), dtype=torch.bfloat16,
                                                device=cuda_device), s[:32])
    wide = torch.zeros((1, 8, 2048), device=cuda_device)
    s2 = torch.ones(2048, device=cuda_device)
    with pytest.raises(ValueError, match="rows of at most"):
        tfa.ln_matmul_gelu(wide, s2, s2, torch.zeros((2048, 32), device=cuda_device), s[:32])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_attn_out_proj_residual_matches_plain(cuda_device, dt):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(DTYPES[dt])  # noqa: E731
    attn, w, b, x = r(2, 3, 77, 64), 0.1 * r(3, 64, 200), r(200), r(2, 77, 200)
    before = tfa.attn_out_proj_residual.launches
    out = tfa.attn_out_proj_residual(attn, w, b, x)
    ref = tfa.attn_out_proj_residual_plain(attn, w, b, x)
    torch.cuda.synchronize()
    assert tfa.attn_out_proj_residual.launches == before + 1
    assert out.shape == x.shape and out.dtype == x.dtype
    tol = 1e-5 if dt == "float32" else 4 * 2.0**-8 * float(ref.abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol


# #7 on the tensor cores: (B, H, T, Dh, M). The encoder's out-projection at
# 4 requests and at one, whisper-large's, a single frame, T 501 (a tile
# straddles two batch rows and the last one is partial), a column-tile tail
# (M 520), heads of 128, and 32 heads of 64 into 2048 (past the CUDA-core
# tile's 1688)
OUT_PROJ_SHAPES = [(4, 12, 500, 64, 768), (1, 12, 500, 64, 768), (1, 20, 1500, 64, 1280),
                   (4, 12, 1, 64, 768), (2, 12, 501, 64, 768), (1, 12, 500, 64, 520),
                   (2, 6, 77, 128, 768), (2, 32, 100, 64, 2048)]


def _out_proj_inputs(dev, B, H, T, Dh, M, dtype, seed=0, offset=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    attn = torch.randn((B * H * T * Dh + offset,), generator=g, device=dev).to(dtype)
    attn = attn[offset:].view(B, H, T, Dh)
    w = (0.05 * torch.randn((H, Dh, M), generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn((M,), generator=g, device=dev)).to(dtype)
    x = torch.randn((B, T, M), generator=g, device=dev).to(dtype)
    return attn, w, b, x


def _out_proj_check(a, w, b, x, kernel):
    """Within 1e-5 of the largest output (fp32) or 4 bf16 ulps of the plain
    version, two calls bit-equal, one launch each, and only ``kernel`` in a
    trace."""
    before = tfa.attn_out_proj_residual.launches
    out = tfa.attn_out_proj_residual(a, w, b, x)
    again = tfa.attn_out_proj_residual(a, w, b, x)
    ref = tfa.attn_out_proj_residual_plain(a, w, b, x)
    torch.cuda.synchronize()
    assert tfa.attn_out_proj_residual.launches == before + 2
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.equal(out, again)
    big = float(ref.abs().max())
    tol = 1e-5 * max(1.0, big) if x.dtype == torch.float32 else 4 * 2.0**-8 * big
    assert float((out.float() - ref.float()).abs().max()) <= tol
    names = _device_kernel_names(lambda: tfa.attn_out_proj_residual(a, w, b, x))
    assert len(names) == 1 and f"{kernel}<" in next(iter(names)), names
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OUT_PROJ_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attn_out_proj_residual_tensor_cores_at_every_shape(cuda_device, shape):
    """bf16 takes attn_out_proj_mma_kernel at every shape, 2048 wide too."""
    a, w, b, x = _out_proj_inputs(cuda_device, *shape, torch.bfloat16)
    _out_proj_check(a, w, b, x, "attn_out_proj_mma_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 2, 3, 4, 5])
def test_attn_out_proj_residual_every_tile(cuda_device, tiles, monkeypatch):
    """Each tensor-core tile and each count of column tiles a block runs,
    forced in turn, at (2, 12, 501, 64) x 520: rows no tile divides, tiles
    that straddle two batch rows, a column-tile tail and a last block with
    fewer column tiles. Every one gives the plan's output bit for bit: each
    output's sum runs the same mma steps in the same order."""
    import functools

    a, w, b, x = _out_proj_inputs(cuda_device, 2, 12, 501, 64, 520, torch.bfloat16)
    want = tfa.attn_out_proj_residual(a, w, b, x)
    plan = tfa._out_proj_plan
    for bm in tfa.MMA_ROWS:
        monkeypatch.setattr(tfa, "_out_proj_plan", functools.partial(plan, bm=bm, tiles=tiles))
        assert torch.equal(_out_proj_check(a, w, b, x, "attn_out_proj_mma_kernel"), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp32", "unaligned bf16"])
def test_attn_out_proj_residual_cuda_core_routes(cuda_device, case):
    """fp32, and a bf16 attn one element off its storage (no 16-byte
    copies), take the CUDA-core attn_out_proj_kernel."""
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    a, w, b, x = _out_proj_inputs(cuda_device, 2, 12, 77, 64, 768, dtype,
                                  offset=int(case != "fp32"))
    _out_proj_check(a, w, b, x, "attn_out_proj_kernel")


@pytest.mark.cuda
def test_attn_out_proj_residual_tensor_core_kernels_hold_hmma(cuda_device):
    """cuobjdump's SASS: HMMA in every tensor-core instance, none in the
    fp32 CUDA-core kernel."""
    import os
    import subprocess

    from ultravox_torch.ops.kernels import _build

    path = _build.build_all(["attn_out_proj"])["attn_out_proj"]["path"]
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    hmma = {b.split("\n", 1)[0].strip(): b.count("HMMA") for b in sass.split("Function : ")[1:]}
    mma = [c for n, c in hmma.items() if "attn_out_proj_mma_kernel" in n]
    fp32 = [c for n, c in hmma.items() if "attn_out_proj_kernelIf" in n]
    assert len(mma) == len(tfa.MMA_ROWS) and all(mma), hmma
    assert len(fp32) == 1 and not fp32[0], hmma


@pytest.mark.cuda
def test_attn_out_proj_residual_raises_on_what_the_kernel_lacks(cuda_device):
    attn = torch.zeros((1, 2, 8, 64), device=cuda_device)
    w = torch.zeros((2, 64, 32), device=cuda_device)
    x = torch.zeros((1, 8, 32), device=cuda_device)
    with pytest.raises(ValueError, match="bias dtype"):
        tfa.attn_out_proj_residual(attn, w, torch.zeros(32, dtype=torch.bfloat16,
                                                        device=cuda_device), x)
    with pytest.raises(TypeError, match="share"):
        tfa.attn_out_proj_residual(attn.bfloat16(), w, torch.zeros(32, device=cuda_device), x)
    with pytest.raises(ValueError, match="shapes"):
        tfa.attn_out_proj_residual(attn, w[:1], torch.zeros(32, device=cuda_device), x)
    wide = torch.zeros((1, 32, 8, 64), device=cuda_device)  # fp32 past the row tile's 1688
    with pytest.raises(ValueError, match="rows of at most"):
        tfa.attn_out_proj_residual(wide, torch.zeros((32, 64, 32), device=cuda_device),
                                   torch.zeros(32, device=cuda_device), x)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no-mask"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("exp", ["float32", "bfloat16"])
@pytest.mark.parametrize("probe", ["attn_v2", "attn_nt"])
def test_encoder_attn_probe_matches_plain(cuda_device, probe, exp, dt, masked):
    """T = 192 (three 64-row tiles), S = 150 (a ragged key tile), 3 heads,
    ragged lengths: the probes against their plain version; fp32 inputs
    with the fp32 exponent within 1e-5, else 4 bf16 ulps of the largest
    output."""
    from ultravox_torch.ops.kernels import encoder_attn_probe as tprobe

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((2, 192, 3, 64), generator=g, device=cuda_device).to(DTYPES[dt])
    k, v = (torch.randn((2, 150, 3, 64), generator=g, device=cuda_device).to(DTYPES[dt])
            for _ in range(2))
    lens = torch.tensor([150, 41], dtype=torch.int32, device=cuda_device) if masked else None
    fn = getattr(tprobe, probe)
    before = fn.launches
    out = fn(q, k, v, lens, scale=0.125, block_q=64, exp_dtype=DTYPES[exp])
    ref = tprobe.attn_probe_plain(q, k, v, lens, scale=0.125, exp_dtype=DTYPES[exp])
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    exact = dt == "float32" and exp == "float32"
    tol = 1e-5 if exact else 4 * 2.0**-8 * float(ref.abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_encoder_attn_probe_fp32_equals_the_production_kernel(cuda_device):
    """With the fp32 exponent both probes compute what fused_attention
    computes (its key mask replaces the logit by NEG_INF where theirs adds
    it; the sums round alike): bit-equal in bf16 at head_dim 128."""
    from ultravox_torch.ops.kernels import encoder_attn_probe as tprobe

    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn((2, 100, 2, 128), generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    lens = torch.tensor([100, 9], dtype=torch.int32, device=cuda_device)
    ref = tfa.fused_attention(q, k, v, lens, scale=128**-0.5)
    for fn in (tprobe.attn_v2, tprobe.attn_nt):
        out = fn(q, k, v, lens, scale=128**-0.5, block_q=50)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.cuda
def test_encoder_attn_probe_raises_on_what_the_kernel_lacks(cuda_device):
    from ultravox_torch.ops.kernels import encoder_attn_probe as tprobe

    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    for fn in (tprobe.attn_v2, tprobe.attn_nt):
        with pytest.raises(ValueError, match="block_q"):
            fn(q, q, q, scale=0.125, block_q=100)
        with pytest.raises(ValueError, match="head_dim"):
            fn(q[..., :32], q[..., :32], q[..., :32], scale=0.125, block_q=64)
        with pytest.raises(TypeError):
            fn(q.half(), q.half(), q.half(), scale=0.125, block_q=64)


# --------------------------------------------------------------------------
# the split KV kernel (csrc/kv_split.cuh) behind #8 decode_attention and
# #11 segment_tail_attention
# --------------------------------------------------------------------------

# every length at the granule (16 keys) and split (32 keys per block) edges
# of a 256-slot slab (8 blocks per cluster), a row of length 0, and short
# rows that leave ranks empty
EDGE_LENS = [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 144, 255, 256]


def _kv_tol(dtype, ref):
    return 1e-5 if dtype == torch.float32 else 4 * 2.0**-8 * float(ref.abs().max())


def _kv_randn(dev, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)


def _seg_visible(lens, written, T, S, Ts, window):
    """(prompt (B, T, S), tail (B, T, Ts)) visibility of segment_tail_attention."""
    dev = lens.device
    t = torch.arange(T, device=dev)[None, :, None]
    n, wr = lens.long()[:, None, None], written.long()[:, None, None]
    kpos, slot = torch.arange(S, device=dev), torch.arange(Ts, device=dev)
    ok_p, ok_t = kpos < n, slot <= wr + t
    if window:
        ok_p = ok_p & (n + wr + t - kpos < window)
        ok_t = ok_t & (wr + t - slot < window)
    return ok_p, ok_t


def _split_decode(dev, dtype, D, G, S, lens, seed=0, Hkv=2):
    r = _kv_randn(dev, dtype, seed)
    B = len(lens)
    return (r(B, Hkv * G, D), r(B, S, Hkv, D), r(B, S, Hkv, D),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _split_segment(dev, dtype, D, G, T, S, Ts, lens, seed=0, Hkv=2):
    """q (B, T, H, D) against layer 1 of a 2-layer cache and a Ts-slot tail;
    row i has written (7 i) mod (Ts - T + 1) slots before its queries."""
    r = _kv_randn(dev, dtype, seed)
    B = len(lens)
    written = torch.tensor([(7 * i) % (Ts - T + 1) for i in range(B)], dtype=torch.int32,
                           device=dev)
    return (r(B, T, Hkv * G, D), r(2, B, S, Hkv, D), r(2, B, S, Hkv, D), r(B, Ts, Hkv, D),
            r(B, Ts, Hkv, D), torch.tensor(lens, dtype=torch.int32, device=dev), written)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("window", [0, 8, 32])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_split_decode_attention_matches_plain(cuda_device, D, G, window, dt):
    """#8 on the split kernel at EDGE_LENS: within 1e-5 (fp32) or 4 bf16
    ulps, a row of length 0 gives 0, one launch a call, two runs bit-equal."""
    dtype = DTYPES[dt]
    q, k, v, lens = _split_decode(cuda_device, dtype, D, G, 256, EDGE_LENS)
    before = tda.decode_attention.launches
    out, again = (tda.decode_attention(q, k, v, lens, window) for _ in range(2))
    ref = tda.decode_attention_plain(q, k, v, lens, window, scale=D**-0.5)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 2
    assert out.shape == ref.shape and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= _kv_tol(dtype, ref)
    assert torch.equal(out, again)
    assert not out[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("window", [0, 8, 32])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_split_segment_tail_attention_matches_plain(cuda_device, D, G, T, window, dt):
    """#11 on the split kernel: prompt lengths EDGE_LENS on a 256-slot cache
    plus a 32-slot tail (8 blocks per cluster; splits fall in the prompt and
    in the tail), 0-29 tail slots written; within tolerance, one launch a
    call, two runs bit-equal."""
    dtype = DTYPES[dt]
    args = _split_segment(cuda_device, dtype, D, G, T, 256, 32, EDGE_LENS)
    q, kc, vc, tk, tv, lens, written = args
    before = tsa.segment_tail_attention.launches
    out, again = (tsa.segment_tail_attention(q, kc, vc, 1, lens, tk, tv, written, window)
                  for _ in range(2))
    ref = tsa.segment_tail_attention_plain(q, kc, vc, 1, lens, tk, tv, written, window,
                                           scale=D**-0.5)
    torch.cuda.synchronize()
    assert tsa.segment_tail_attention.launches == before + 2
    assert out.shape == ref.shape and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= _kv_tol(dtype, ref)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_split_kernels_at_the_serving_slab(cuda_device, dt):
    """Serving run (c)'s shapes: a 2048-slot slab with 129-190 keys, GQA 4,
    head_dim 64; the segment kernel with an 8-slot tail (0-7 written)."""
    dtype = DTYPES[dt]
    lens = [129, 150, 171, 190]
    q, k, v, n = _split_decode(cuda_device, dtype, 64, 4, 2048, lens, seed=1, Hkv=8)
    out = tda.decode_attention(q, k, v, n)
    ref = tda.decode_attention_plain(q, k, v, n, scale=0.125)
    q, kc, vc, tk, tv, n, written = _split_segment(cuda_device, dtype, 64, 4, 1, 2048, 8, lens,
                                                   seed=2, Hkv=8)
    out_s = tsa.segment_tail_attention(q, kc, vc, 1, n, tk, tv, written)
    ref_s = tsa.segment_tail_attention_plain(q, kc, vc, 1, n, tk, tv, written, scale=0.125)
    torch.cuda.synchronize()
    for o, r_ in ((out, ref), (out_s, ref_s)):
        assert float((o.float() - r_.float()).abs().max()) <= _kv_tol(dtype, r_)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("window", [0, 32])
def test_segment_kernels_at_the_spec_verify_shape(cuda_device, dt, window):
    """#11 and #12 at the speculative verify forward of the flagship: q (4,
    9, 32, 64) (T = K+1 = 9, 36 query columns a KV head), Hkv 8, a 2048-slot
    slab with 129-190 keys (and the same keys in shuffled pages of 256), a
    72-slot tail (8 rounds) with 0, 6, 12 and 18 slots written; within
    tolerance of the plain versions, one launch a call, two runs bit-equal,
    paged equal to the slab."""
    dtype = DTYPES[dt]
    lens = [129, 150, 171, 190]
    q, kc, vc, tk, tv, n, _ = _split_segment(cuda_device, dtype, 64, 4, 9, 2048, 72, lens,
                                             seed=5, Hkv=8)
    written = torch.tensor([0, 6, 12, 18], dtype=torch.int32, device=cuda_device)
    before = tsa.segment_tail_attention.launches
    out, again = (tsa.segment_tail_attention(q, kc, vc, 1, n, tk, tv, written, window)
                  for _ in range(2))
    ref = tsa.segment_tail_attention_plain(q, kc, vc, 1, n, tk, tv, written, window, scale=0.125)
    ps, n_per = 256, 8
    order = torch.from_numpy(np.random.default_rng(6).permutation(4 * n_per).astype(np.int32))
    table = order.view(4, n_per).to(cuda_device)
    kp = torch.empty((2, 4 * n_per, ps, 8, 64), dtype=dtype, device=cuda_device)
    vp = torch.empty_like(kp)
    for b in range(4):
        for i in range(n_per):
            kp[:, table[b, i]] = kc[:, b, i * ps:(i + 1) * ps]
            vp[:, table[b, i]] = vc[:, b, i * ps:(i + 1) * ps]
    before_p = tsa.paged_segment_tail_attention.launches
    out_p, again_p = (tsa.paged_segment_tail_attention(q, kp, vp, 1, table, n, tk, tv, written,
                                                       window) for _ in range(2))
    ref_p = tsa.paged_segment_tail_attention_plain(q, kp, vp, 1, table, n, tk, tv, written,
                                                   window, scale=0.125)
    torch.cuda.synchronize()
    assert tsa.segment_tail_attention.launches == before + 2
    assert tsa.paged_segment_tail_attention.launches == before_p + 2
    for o, a, r_ in ((out, again, ref), (out_p, again_p, ref_p)):
        assert o.shape == (4, 9, 32, 64) and o.dtype == dtype
        assert float((o.float() - r_.float()).abs().max()) <= _kv_tol(dtype, r_)
        assert torch.equal(o, a)
    assert torch.equal(ref, ref_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("window", [0, 8, 32])
def test_split_kernels_ignore_hidden_slots(cuda_device, dt, window):
    """1e4 in every cache and tail slot that no query of a row sees moves
    no output bit: those slots are never read."""
    dtype = DTYPES[dt]
    q, k, v, lens = _split_decode(cuda_device, dtype, 64, 4, 256, EDGE_LENS, seed=3)
    pos = torch.arange(256, device=cuda_device)[None]
    n = lens.long()[:, None]
    hidden = (pos >= n) | ((pos < n - window) if window else torch.zeros_like(pos, dtype=torch.bool))
    jk, jv = k.clone(), v.clone()
    jk[hidden], jv[hidden] = 1e4, 1e4
    assert torch.equal(tda.decode_attention(q, jk, jv, lens, window),
                       tda.decode_attention(q, k, v, lens, window))

    T, Ts = 3, 32
    q, kc, vc, tk, tv, lens, written = _split_segment(cuda_device, dtype, 64, 4, T, 256, Ts,
                                                      EDGE_LENS, seed=4)
    ok_p, ok_t = _seg_visible(lens, written, T, 256, Ts, window)
    jk, jv, jtk, jtv = kc.clone(), vc.clone(), tk.clone(), tv.clone()
    jk[1][~ok_p.any(1)], jv[1][~ok_p.any(1)] = 1e4, 1e4
    jtk[~ok_t.any(1)], jtv[~ok_t.any(1)] = 1e4, 1e4
    out = tsa.segment_tail_attention(q, kc, vc, 1, lens, tk, tv, written, window)
    junk = tsa.segment_tail_attention(q, jk, jv, 1, lens, jtk, jtv, written, window)
    torch.cuda.synchronize()
    assert torch.equal(out, junk)


@pytest.mark.cuda
def test_split_kernels_show_their_names_in_a_trace(cuda_device):
    """#8, #9, #11 and #12 launch the cluster kernels under their own
    __global__ names (no one-block kernel)."""
    q, k, v, lens = _split_decode(cuda_device, torch.bfloat16, 64, 4, 256, [144, 0, 33])
    names = _device_kernel_names(lambda: tda.decode_attention(q, k, v, lens))
    assert any("decode_attention_split_kernel" in n for n in names), sorted(names)
    assert not any("decode_attention_kernel<" in n for n in names), sorted(names)
    q, kc, vc, tk, tv, lens, written = _split_segment(cuda_device, torch.bfloat16, 64, 4, 1,
                                                      256, 31, [128, 0, 33])
    names = _device_kernel_names(
        lambda: tsa.segment_tail_attention(q, kc, vc, 1, lens, tk, tv, written))
    assert any("segment_attention_split_kernel" in n for n in names), sorted(names)
    assert not any("segment_attention_kernel<" in n for n in names), sorted(names)
    kp, vp, table, plens, _ = _paged_case(cuda_device, torch.bfloat16)
    qp = torch.zeros((4, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    names = _device_kernel_names(lambda: tpa.paged_decode_attention(qp, kp[1], vp[1], table, plens))
    assert any("paged_decode_attention_split_kernel" in n for n in names), sorted(names)
    assert not any("paged_decode_attention_kernel<" in n for n in names), sorted(names)
    qs = torch.zeros((4, 1, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    tk = torch.zeros((4, 8, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    written = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda_device)
    names = _device_kernel_names(
        lambda: tsa.paged_segment_tail_attention(qs, kp, vp, 1, table, plens, tk, tk, written))
    assert any("paged_segment_attention_split_kernel" in n for n in names), sorted(names)
    assert not any("paged_segment_attention_kernel<" in n for n in names), sorted(names)


@pytest.mark.cuda
def test_split_kernels_raise_on_misaligned_views(cuda_device):
    """The split kernel loads 16-byte pieces: a cache view off a 16-byte
    boundary raises ValueError."""
    def shifted(t):  # t's shape, 2 bytes past a 16-byte boundary
        return torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda_device)[1:].view(t.shape)

    q, k, v, lens = _split_decode(cuda_device, torch.bfloat16, 64, 4, 64, [10, 20])
    with pytest.raises(ValueError, match="16-byte"):
        tda.decode_attention(q, shifted(k), shifted(v), lens)
    q, kc, vc, tk, tv, lens, written = _split_segment(cuda_device, torch.bfloat16, 64, 4, 1, 64,
                                                      8, [10, 20])
    with pytest.raises(ValueError, match="16-byte"):
        tsa.segment_tail_attention(q, kc, vc, 1, lens, shifted(tk), shifted(tv), written)


# sha256 (first 16 hex digits) of #8's and #11's outputs on
# compare_kernels.kv_pin_inputs, from the build before the paged instances
# joined kv_split.cuh (python -m ultravox_torch.scripts.compare_kernels on an
# H100 printed the same digests for that build and this one)
KV_PIN_DIGESTS = {
    "decode_attention bfloat16": "9c1edd62552fac47",
    "segment_tail_attention bfloat16": "813549cbdb22ee45",
    "decode_attention float32": "b830fac73b87ddea",
    "segment_tail_attention float32": "d4b5bb5d4c06f3e7",
}


@pytest.mark.cuda
def test_contiguous_kv_kernels_are_bit_equal_to_their_build_before_paging(cuda_device):
    """#8 and #11, the contiguous instances of kv_split.cuh, which the paged
    instances now share: their outputs on fixed inputs equal, bit for bit,
    those of the build before the paged instances."""
    from ultravox_torch.scripts.compare_kernels import kv_pin_digests

    assert kv_pin_digests(cuda_device) == KV_PIN_DIGESTS


# --------------------------------------------------------------------------
# the paged instances of the split KV kernel behind #9 paged_decode_attention
# and #12 paged_segment_tail_attention
# --------------------------------------------------------------------------

def _junk(t, hidden):
    out = t.clone()
    out[hidden] = 1e4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("ps", [16, 48, 256])
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_split_paged_decode_attention_matches_plain(cuda_device, D, G, window, ps, dt):
    """#9 on the paged split kernel at compare_kernels.PAGED_EDGE_LENS
    (window 37 starts mid-page):
    within 1e-5 (fp32) or 4 bf16 ulps, a row of length 0 gives 0, one launch
    a call, two runs bit-equal, and 1e4 in every pool slot no row sees moves
    no output bit."""
    dtype = DTYPES[dt]
    c = paged_edge_inputs(cuda_device, dtype, D, G, ps, window)
    q, kp, vp, table, lens, hidden = (c["q"], c["kp"][1], c["vp"][1], c["table"], c["lens"],
                                      c["hidden"])
    before = tpa.paged_decode_attention.launches
    out, again = (tpa.paged_decode_attention(q, kp, vp, table, lens, window) for _ in range(2))
    ref = tpa.paged_decode_attention_plain(q, kp, vp, table, lens, window, scale=D**-0.5)
    junk = tpa.paged_decode_attention(q, _junk(kp, hidden), _junk(vp, hidden), table, lens, window)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 3
    assert out.shape == ref.shape and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= _kv_tol(dtype, ref)
    assert torch.equal(out, again)
    assert torch.equal(out, junk)
    assert not out[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("ps", [16, 48, 256])
@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_split_paged_segment_tail_attention_matches_plain(cuda_device, D, G, T, window, ps, dt):
    """#12 on the paged split kernel: prompt lengths PAGED_EDGE_LENS at layer 1 of
    the pool plus a 32-slot tail (splits fall in the pool and in the tail),
    0-29 slots written; within tolerance, one launch a call, two runs
    bit-equal, and 1e4 in every pool and tail slot no query sees moves no
    output bit."""
    dtype = DTYPES[dt]
    c = paged_edge_inputs(cuda_device, dtype, D, G, ps, window, T=T)
    q, kp, vp, table, lens = c["q"], c["kp"], c["vp"], c["table"], c["lens"]
    tk, tv, written = c["tk"], c["tv"], c["written"]
    hidden, hidden_t = c["hidden"], c["hidden_tail"]
    before = tsa.paged_segment_tail_attention.launches
    out, again = (tsa.paged_segment_tail_attention(q, kp, vp, 1, table, lens, tk, tv, written,
                                                   window) for _ in range(2))
    ref = tsa.paged_segment_tail_attention_plain(q, kp, vp, 1, table, lens, tk, tv, written,
                                                 window, scale=D**-0.5)
    jk, jv = kp.clone(), vp.clone()
    jk[1][hidden], jv[1][hidden] = 1e4, 1e4
    jk[0], jv[0] = 1e4, 1e4  # another layer
    junk = tsa.paged_segment_tail_attention(q, jk, jv, 1, table, lens, _junk(tk, hidden_t),
                                            _junk(tv, hidden_t), written, window)
    torch.cuda.synchronize()
    assert tsa.paged_segment_tail_attention.launches == before + 3
    assert out.shape == ref.shape and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= _kv_tol(dtype, ref)
    assert torch.equal(out, again)
    assert torch.equal(out, junk)


@pytest.mark.cuda
def test_split_paged_kernels_raise_on_misaligned_views(cuda_device):
    """The paged split kernel loads 16-byte pieces: a pool or tail view off
    a 16-byte boundary raises ValueError."""
    def shifted(t):  # t's shape, 2 bytes past a 16-byte boundary
        return torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda_device)[1:].view(t.shape)

    c = paged_edge_inputs(cuda_device, torch.bfloat16, 64, 4, 48, T=1, Ts=8)
    with pytest.raises(ValueError, match="16-byte"):
        tpa.paged_decode_attention(c["q"][:, 0], shifted(c["kp"][1]), shifted(c["vp"][1]),
                                   c["table"], c["lens"])
    with pytest.raises(ValueError, match="16-byte"):
        tsa.paged_segment_tail_attention(c["q"], c["kp"], c["vp"], 1, c["table"], c["lens"],
                                         shifted(c["tk"]), shifted(c["tv"]), c["written"])


# --------------------------------------------------------------------------
# #14 decode_matmul's one-launch kernel (clusters splitting K, bf16 x on the
# tensor cores) and #1 fused_layer_norm's warp-per-row kernel
# --------------------------------------------------------------------------


def _dm_inputs(dev, M, K, N, weight, xdt, offset=False, seed=0):
    """x (M, K) and a bf16 or int8 + per-channel-scale weight (K, N); with
    ``offset`` the weight is a contiguous view one element past its
    storage's start, so no vector load is aligned."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(xdt)
    w = 0.02 * torch.randn((K, N), generator=g, device=dev)
    scale = None
    if weight == "int8":
        scale = w.abs().amax(dim=0) / 127
        w = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    else:
        w = w.to(torch.bfloat16)
    if offset:
        flat = torch.empty(K * N + 1, dtype=w.dtype, device=dev)
        flat[1:] = w.reshape(-1)
        w = flat[1:].view(K, N)
    return x, w, scale


def _dm_check(tdm, x, w, scale, out_dtype):
    """One launch (the counter rises by 1), the plain version's value within
    1e-5 of the largest fp32 output or 4 bf16 ulps, and a second call
    bit-equal to the first."""
    before = tdm.decode_matmul.launches
    out = tdm.decode_matmul(x, w, scale, out_dtype=out_dtype)
    ref = tdm.decode_matmul_plain(x, w, scale, out_dtype)
    again = tdm.decode_matmul(x, w, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tdm.decode_matmul.launches == before + 2
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.equal(out, again)
    big = float(ref.abs().max())
    tol = 1e-5 * max(1.0, big) if out.dtype == torch.float32 else 4 * 2.0**-8 * big
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", list(DTYPES))
@pytest.mark.parametrize("weight", ["bfloat16", "int8"])
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 17, 32])
def test_decode_matmul_every_row_count(cuda_device, M, weight, xdt):
    """Every row count against the tensor-core kernel's 8/16/32-row groups
    and the CUDA-core kernel's 1/4/8/16/32 sums; int8 with an fp32, a bf16
    and no scale; both output dtypes; a K that is no multiple of 16; N wide
    enough that int8 keeps 16 columns a lane below 32 rows."""
    from ultravox_torch.ops.kernels import decode_matmul as tdm

    x, w, scale = _dm_inputs(cuda_device, M, 1000, 8704, weight, DTYPES[xdt])
    scales = (None,) if scale is None else (scale, scale.bfloat16(), None)
    for sc in scales:
        for out_dtype in (None, torch.float32):
            _dm_check(tdm, x, w, sc, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", list(DTYPES))
@pytest.mark.parametrize("weight", ["bfloat16", "int8"])
@pytest.mark.parametrize("warps_n", [1, 4])
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 5, 6, 7, 8])
def test_decode_matmul_every_cluster_size(cuda_device, cluster, warps_n, weight, xdt,
                                          monkeypatch):
    """K = 4096 split over clusters of 1 to 8 blocks, with 1 or 4 warps of a
    block side by side along N (the plan forced; fp32 x keeps one), at 4 and
    17 rows: every merge in rank order within tolerance and bit-equal on
    repeat."""
    import functools

    from ultravox_torch.ops.kernels import decode_matmul as tdm

    plan = tdm._plan
    monkeypatch.setattr(tdm, "_plan", functools.partial(plan, cluster=cluster, warps_n=warps_n))
    for M in (4, 17):
        x, w, scale = _dm_inputs(cuda_device, M, 4096, 640, weight, DTYPES[xdt])
        got = tdm._plan(M, 4096, 640, w.element_size(), w.data_ptr(),
                        x.dtype == torch.bfloat16, 132)
        assert got.cluster == cluster and got.warps_n == (warps_n if xdt == "bfloat16" else 1)
        for out_dtype in (None, torch.float32):
            _dm_check(tdm, x, w, scale, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", list(DTYPES))
@pytest.mark.parametrize("weight", ["bfloat16", "int8"])
@pytest.mark.parametrize("kn", [(300, 1001), (2048, 3072), (64, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_decode_matmul_unaligned_weight(cuda_device, kn, weight, xdt):
    """A weight view one element off its storage, and an odd N: the
    element-load instance (tensor cores) or one column a lane (CUDA cores)."""
    from ultravox_torch.ops.kernels import decode_matmul as tdm

    K, N = kn
    for M in (1, 4, 32):
        x, w, scale = _dm_inputs(cuda_device, M, K, N, weight, DTYPES[xdt], offset=True)
        plan = tdm._plan(M, K, N, w.element_size(), w.data_ptr(), x.dtype == torch.bfloat16, 132)
        assert not plan.vec or plan.cols == 1
        for out_dtype in (None, torch.float32):
            _dm_check(tdm, x, w, scale, out_dtype)


@pytest.mark.cuda
def test_decode_matmul_is_one_kernel_on_the_tensor_cores(cuda_device):
    """One device kernel a call at a K-split shape: bf16 x runs the
    tensor-core kernel, fp32 x the CUDA-core one, no reduce kernel."""
    from ultravox_torch.ops.kernels import decode_matmul as tdm

    for xdt, name in ((torch.bfloat16, "decode_matmul_mma_kernel"),
                      (torch.float32, "decode_matmul_kernel")):
        for weight in ("bfloat16", "int8"):
            x, w, scale = _dm_inputs(cuda_device, 4, 8192, 2048, weight, xdt)
            names = _device_kernel_names(lambda: tdm.decode_matmul(x, w, scale))
            assert len(names) == 1 and name in next(iter(names)), names


LN_DIMS = [200, 768, 1280, 4096, 5000]  # 5000: past the warp kernel, a block a row


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rows", [1, 3, 2000])
@pytest.mark.parametrize("D", LN_DIMS)
def test_layer_norm_every_instance(cuda_device, D, rows, dt):
    """The warp-per-row kernel (16-byte pieces, and element pieces for an x
    one element off its storage) and the block-per-row kernel past D 4096:
    within 1e-5 (fp32) or 4 bf16 ulps, one launch a call, bit-equal on
    repeat."""
    g = torch.Generator(device=cuda_device).manual_seed(D + rows)
    dtype = DTYPES[dt]
    base = (torch.randn(rows * D + 1, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    s = 1 + 0.2 * torch.randn(D, generator=g, device=cuda_device)
    b = 0.2 * torch.randn(D, generator=g, device=cuda_device)
    for x in (base[:-1].view(rows, D), base[1:].view(rows, D)):
        before = tln.fused_layer_norm.launches
        out = tln.fused_layer_norm(x, s, b)
        again = tln.fused_layer_norm(x, s, b)
        ref = tln.layer_norm_plain(x, s, b)
        torch.cuda.synchronize()
        assert tln.fused_layer_norm.launches == before + 2
        assert out.dtype == dtype and out.shape == x.shape
        assert torch.equal(out, again)
        tol = 1e-5 if dt == "float32" else 4 * 2.0**-8 * float(ref.abs().max())
        assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_layer_norm_is_one_kernel(cuda_device):
    """(4, 500, 768) bf16 queues the warp-per-row kernel alone."""
    x = torch.randn((4, 500, 768), device=cuda_device).bfloat16()
    s, b = torch.ones(768, device=cuda_device), torch.zeros(768, device=cuda_device)
    names = _device_kernel_names(lambda: tln.fused_layer_norm(x, s, b))
    assert len(names) == 1 and "layer_norm_warp_kernel" in next(iter(names)), names


# #2 ln_qkv_head_fused: (B, T, D, C, head_dim). The encoder's shapes at 4
# requests and at one (serving's admissions), a single frame, a ragged
# shape (C not a multiple of any tile's columns, 77 rows), whisper-large's
# width (the plan's 64-row tile at D 1280).
LN_QKV_SHAPES = [(4, 500, 768, 2304, 64), (1, 500, 768, 2304, 64), (4, 1, 768, 2304, 64),
                 (2, 77, 96, 288, 32), (1, 1500, 1280, 3840, 64)]


def _ln_qkv_inputs(dev, B, T, D, C, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, T, D), generator=g, device=dev).to(dtype)
    s = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
    b = 0.1 * torch.randn((D,), generator=g, device=dev)
    w = (0.05 * torch.randn((D, C), generator=g, device=dev)).to(dtype)
    wb = (0.05 * torch.randn((C,), generator=g, device=dev)).to(dtype)
    return x, s, b, w, wb


def _ln_qkv_check(x, s, b, w, wb, Dh, kernel):
    """Within 1e-5 (fp32) or 4 bf16 ulps of the plain version, two calls
    bit-equal, one launch each, and only ``kernel`` in a trace."""
    before = tfa.ln_qkv_head_fused.launches
    out = tfa.ln_qkv_head_fused(x, s, b, w, wb, Dh)
    again = tfa.ln_qkv_head_fused(x, s, b, w, wb, Dh)
    ref = tfa.ln_qkv_head_plain(x, s, b, w, wb, Dh)
    torch.cuda.synchronize()
    assert tfa.ln_qkv_head_fused.launches == before + 2
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.equal(out, again)
    tol = 1e-5 if x.dtype == torch.float32 else 4 * 2.0**-8 * float(ref.abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol
    names = _device_kernel_names(lambda: tfa.ln_qkv_head_fused(x, s, b, w, wb, Dh))
    assert len(names) == 1 and f"{kernel}<" in next(iter(names)), names


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", LN_QKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ln_qkv_head_matches_plain(cuda_device, shape, dt):
    """bf16 on the tensor cores (ln_qkv_head_mma_kernel), fp32 on the CUDA
    cores (ln_qkv_head_kernel)."""
    B, T, D, C, Dh = shape
    dtype = DTYPES[dt]
    x, s, b, w, wb = _ln_qkv_inputs(cuda_device, B, T, D, C, dtype)
    kernel = "ln_qkv_head_mma_kernel" if dtype == torch.bfloat16 else "ln_qkv_head_kernel"
    _ln_qkv_check(x, s, b, w, wb, Dh, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 77, 96, 288, 32), (3, 61, 656, 1544, 8), (3, 61, 784, 1544, 8),
                                   (1, 1, 768, 2304, 64)], ids=lambda s: "x".join(map(str, s)))
def test_ln_qkv_head_every_tile(cuda_device, shape, monkeypatch):
    """Each tensor-core tile that fits, forced in turn, at ragged shapes:
    rows and columns that no tile divides, D 656 and 784 (a last weight
    stage half full; 784 past 3 pieces a lane, where 128 rows no longer
    fit), heads of 8. A tile that does not fit raises before any launch."""
    import functools

    B, T, D, C, Dh = shape
    plan = tfa._plan
    fits = [m for m in tfa.MMA_ROWS if tfa.mma_smem_bytes(m, D) <= tfa.MAX_SMEM]
    assert fits
    for bm in tfa.MMA_ROWS:
        monkeypatch.setattr(tfa, "_plan", functools.partial(plan, bm=bm))
        x, s, b, w, wb = _ln_qkv_inputs(cuda_device, B, T, D, C, torch.bfloat16, seed=bm)
        if bm in fits:
            _ln_qkv_check(x, s, b, w, wb, Dh, "ln_qkv_head_mma_kernel")
        else:
            with pytest.raises(ValueError, match="cannot run"):
                tfa.ln_qkv_head_fused(x, s, b, w, wb, Dh)


@pytest.mark.cuda
def test_ln_qkv_head_unaligned_view_takes_the_cuda_cores(cuda_device):
    """A bf16 x one element off its storage cannot take 16-byte copies: the
    plan routes it to the CUDA-core kernel, which still holds 4 ulps."""
    x, s, b, w, wb = _ln_qkv_inputs(cuda_device, 2, 77, 768, 2304, torch.bfloat16)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    xv = base[1:].view(x.shape).copy_(x)
    _ln_qkv_check(xv, s, b, w, wb, 64, "ln_qkv_head_kernel")


@pytest.mark.cuda
def test_ln_qkv_head_tensor_core_kernels_hold_hmma(cuda_device):
    """cuobjdump's SASS: HMMA in every tensor-core instance, none in the
    fp32 CUDA-core kernel."""
    import os
    import subprocess

    from ultravox_torch.ops.kernels import _build

    path = _build.build_all(["ln_qkv_head"])["ln_qkv_head"]["path"]
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    hmma = {b.split("\n", 1)[0].strip(): b.count("HMMA") for b in sass.split("Function : ")[1:]}
    mma = [c for n, c in hmma.items() if "ln_qkv_head_mma_kernel" in n]
    fp32 = [c for n, c in hmma.items() if "ln_qkv_head_kernelIf" in n]
    assert len(mma) == len(tfa.MMA_ROWS) and all(mma), hmma
    assert len(fp32) == 1 and not fp32[0], hmma


@pytest.mark.cuda
def test_checkpoint_load_on_cuda_is_bit_equal_to_cpu(cuda_device, tmp_path):
    """load_ultravox_checkpoint onto the card (bf16, from the committed
    fp32 checkpoint and from a two-shard bf16 copy the port wrote) gives
    the CPU load's bits, every leaf on the card."""
    import os

    from ultravox_torch.inference.ultravox_infer import load_ultravox_checkpoint
    from ultravox_torch.models.weights import _leaves
    from ultravox_torch.tools.publish import save_pretrained

    fixture = os.path.join(os.path.dirname(__file__), "assets", "tiny_ultravox")
    cfg, cpu, _ = load_ultravox_checkpoint(fixture, torch.bfloat16, device="cpu")
    sharded = save_pretrained(cpu, cfg, str(tmp_path / "sharded"), dtype=None, shards=2)
    for path in (fixture, sharded):
        _, gpu, _ = load_ultravox_checkpoint(path, torch.bfloat16)
        for a, b in zip(_leaves(cpu), _leaves(gpu)):
            assert b.device.type == "cuda" and b.dtype == a.dtype == torch.bfloat16
            assert torch.equal(a.view(torch.int16), b.cpu().view(torch.int16))


@pytest.mark.cuda
def test_seeded_noise_is_equal_on_cuda_and_cpu(cuda_device):
    """The seeded draw's hash bits and its fp32 Exp(1) noise are the same on
    the card and the CPU at the flagship vocabulary, and so are the seeded
    tokens of one sample_slots call."""
    from ultravox_torch.ops import sampling as tsamp

    V = 128256
    seeds = torch.tensor([0, 1234, 0x7FFFFFFE, 99], dtype=torch.int32)
    pos = torch.tensor([128, 129, 7, 2047], dtype=torch.int32)
    bits = tsamp.seeded_bits(seeds, pos, V)
    assert torch.equal(bits, tsamp.seeded_bits(seeds.to(cuda_device), pos.to(cuda_device), V).cpu())
    noise = tsamp.seeded_exponential(seeds, pos, V)
    got = tsamp.seeded_exponential(seeds.to(cuda_device), pos.to(cuda_device), V).cpu()
    assert torch.equal(noise.view(torch.int32), got.view(torch.int32))
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((4, V), generator=g) * 3
    samp = torch.tensor([[0.8, 0, 0.9, 0]] * 4)
    kw = dict(sampled=True, filtered=True)
    cpu = tsamp.sample_slots(logits, samp, None, seeds=seeds, positions=pos, **kw)
    gpu = tsamp.sample_slots(logits.to(cuda_device), samp.to(cuda_device),
                             torch.Generator(device=cuda_device), seeds=seeds.to(cuda_device),
                             positions=pos.to(cuda_device), **kw)
    assert torch.equal(cpu, gpu.cpu())


@pytest.mark.cuda
def test_penalties_and_logprobs_on_cuda_match_cpu(cuda_device):
    """apply_penalties and token_logprobs on the card: within 1e-6 of the
    CPU's at the flagship vocabulary, the same top ids."""
    from ultravox_torch.ops import sampling as tsamp

    g = torch.Generator().manual_seed(1)
    B, V = 4, 128256
    logits = torch.randn((B, V), generator=g) * 3
    counts = torch.randint(0, 3, (B, V), generator=g, dtype=torch.int32)
    mask = torch.rand((B, V), generator=g) < 0.01
    samp = torch.tensor([[0.8, 0, 0.9, 0, 0.5, 0.5, 1.2], [0, 0, 1, 0, 0, 0, 1],
                         [0, 0, 1, 0, 1.0, 0.0, 1.5], [1, 5, 1, 0, 0, 2.0, 0.9]])
    cpu = tsamp.apply_penalties(logits, counts, mask, samp)
    gpu = tsamp.apply_penalties(*(t.to(cuda_device) for t in (logits, counts, mask, samp)))
    assert (gpu.cpu() - cpu).abs().max().item() <= 1e-6
    toks = cpu.argmax(-1).to(torch.int32)
    lc = tsamp.token_logprobs(cpu, toks)
    lg = tsamp.token_logprobs(gpu, toks.to(cuda_device))
    assert (lg[0].cpu() - lc[0]).abs().max().item() <= 1e-6
    assert torch.equal(lg[1].cpu(), lc[1])
    assert (lg[2].cpu() - lc[2]).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_stream_step_on_cuda_matches_cpu(cuda_device, dt):
    """The streaming encoder (plain torch: encoder_stream_step and the
    projector) on the card against its CPU run, on the tiny block-causal
    config of tests/test_streaming_encoder.py: every block's output and
    the embeddings within 1e-5 in fp32 and 4 bf16 ulps of the largest
    value in bf16."""
    from ultravox_torch.inference.streaming import StreamingAudioEncoder

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tc.UltravoxConfig(
        audio_config=tc.WhisperEncoderConfig(d_model=32, num_layers=2, num_heads=2, ffn_dim=64,
                                             max_source_positions=64),
        text_config=tc.DecoderConfig(vocab_size=384, hidden_size=48, intermediate_size=96,
                                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=12),
        hidden_size=64, audio_latency_block_size=8,
    )
    dtype = DTYPES[dt]
    params = tuv.init_params(cfg, torch.Generator().manual_seed(0), dtype)
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(9600) * 0.1).astype(np.float32)
    audio[:960] *= 4.0
    runs = []
    for tree in (params, _to_device(params, cuda_device)):
        enc = StreamingAudioEncoder(tree, cfg, dtype=dtype)
        for i in range(0, len(audio), 1365):
            enc.feed(audio[i: i + 1365])
        embeds = enc.finalize()
        torch.cuda.synchronize()
        runs.append([o.float().cpu() for o in enc._outputs] + [embeds.float().cpu()])
    assert len(runs[0]) == len(runs[1]) == 5  # four blocks, then the embeddings
    for ref, out in zip(*runs):
        tol = 1e-5 if dt == "float32" else 4 * 2.0**-8 * float(ref.abs().max())
        assert float((out - ref).abs().max()) <= tol


def _to_device(tree, device):
    """A parameter tree's copy on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _smoke_tokenizer(out_dir, vocab_size: int) -> str:
    """chip_smoke.py's tokenizer writer (byte-level, llama-3's special
    tokens and chat template, ``tokenizers`` alone) over ``vocab_size`` ids."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke._write_flagship_tokenizer(str(out_dir), vocab_size)


@pytest.mark.cuda
def test_train_loop_on_cuda_launches_flash(cuda_device, tmp_path):
    """The training CLI's config path on the card: test_train.yaml with
    attn_impl flash, widened to heads of 64 (the kernels' head dims), and
    no device given. Two KL micro-steps launch #13 forward for the encoder
    layer and the student's and teacher's decoder layers (no remat), and
    its backward for the student's decoder layers; the losses are finite
    and the files are written."""
    import json
    import os

    from ultravox_torch.ops.kernels import flash_attention as tfl
    from ultravox_torch.training import config as tcfg
    from ultravox_torch.training import train as ttrain

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = {"model_type": "llama", "vocab_size": 512, "hidden_size": 128,
            "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
            "num_key_value_heads": 1}
    audio = {"model_type": "whisper", "num_mel_bins": 80, "d_model": 128, "encoder_layers": 1,
             "encoder_attention_heads": 2, "encoder_ffn_dim": 256, "max_source_positions": 1500}
    cfg = tcfg.get_train_config([
        "--config_path", os.path.join(root, "ultravox_torch/training/configs/test_train.yaml"),
        "--output_dir", str(tmp_path / "out"), "--text_model", "",
        "--tokenizer_path", _smoke_tokenizer(tmp_path / "tok", 512), "--attn_impl", "flash",
        "--text_model_config", json.dumps(text), "--audio_model_config", json.dumps(audio),
        "--report_logs_to", "[]"])
    assert cfg.device is None and cfg.remat is False
    tfl.flash_attention.launches = tfl.flash_attention.bwd_launches = 0
    ttrain.train(cfg)
    steps, L_enc, L_dec = 2, 1, 2
    assert tfl.flash_attention.launches == steps * (L_enc + 2 * L_dec)
    # the tower is frozen (the projector trains), so no backward runs through it
    assert tfl.flash_attention.bwd_launches == steps * L_dec * tfl.BWD_LAUNCHES
    with open(tmp_path / "out" / "train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in log)
    assert {"checkpoint-2", "model.safetensors", "train_config.json"} <= set(
        os.listdir(tmp_path / "out"))
