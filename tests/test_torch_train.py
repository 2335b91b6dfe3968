"""The port's training step against the JAX package's, on the CPU.

Same seeded numpy inputs and parameters on both sides, fp32, JAX at
``highest`` matmul precision (tests/conftest.py).

- ``flash_attention``'s plain version (the CPU route of the kernel wrapper)
  against the Pallas kernel in interpret mode (``block_q=8``): output within
  2e-5 and dq/dk/dv within 5e-5 (the JAX kernel test's own tolerances), and
  its explicit backward against autograd of its forward.
- LoRA (``proj_apply``, ``merge_lora``, ``add_lora``, target selection).
- The encoder's and the decoder's flash paths against the JAX package's
  XLA paths (the JAX tests hold its flash path equal to XLA; interpret mode
  at model level would cost many seconds per test): encoder output within
  3e-5 and gradients within 2e-3, decoder logits within 5e-5 absolute and
  1e-4 relative (the JAX flash tests' tolerances). ``remat`` changes no
  value or gradient.
- Every ported loss on the same logits or hidden states, within 1e-5.
- Two KL train steps (projector + audio LoRA trainable, remat, chunked
  vocabulary) against JAX's ``make_train_step``, and the partition and the
  learning-rate schedules.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import audio_batch, make_configs, make_params
from ultravox_torch.models import config as tc
from ultravox_torch.models import decoder as tdec
from ultravox_torch.models import lora as tlora
from ultravox_torch.models import ultravox as tuv
from ultravox_torch.models import whisper_encoder as tenc
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.ops.kernels import flash_attention as tfl
from ultravox_torch.training import train_step as tts
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import decoder as jdec
from ultravox_tpu.models import lora as jlora
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.models import whisper_encoder as jenc
from ultravox_tpu.ops import mel as jmel
from ultravox_tpu.ops.pallas import flash_attention as jfl
from ultravox_tpu.training import train_step as jts


def _t(tree):
    """A JAX/numpy tree as torch tensors (fp32 stays fp32)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in sorted-key order, as jax.tree.leaves orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _grads(fn, tree):
    """(value, gradients in ``_leaves`` order) of fn(tree) for a torch tree."""
    leaves = [v for _, v in _leaves(tree)]
    for v in leaves:
        v.requires_grad_(True)
    out = fn(tree)
    return out, torch.autograd.grad(out, leaves)


# --------------------------------------------------------------------------
# kernel level: the plain flash_attention against Pallas in interpret mode
# --------------------------------------------------------------------------

CASES = [  # tests/test_flash_attention.py's five, plus a row of length 0
    dict(name="plain", lengths=None, causal=False, window=0, latency_block=0),
    dict(name="lengths", lengths=(11, 16), causal=False, window=0, latency_block=0),
    dict(name="causal", lengths=None, causal=True, window=0, latency_block=0),
    dict(name="causal+len+win", lengths=(13, 16), causal=True, window=5, latency_block=0),
    dict(name="latency", lengths=(16, 9), causal=False, window=0, latency_block=4),
    dict(name="zero-length-row", lengths=(0, 16), causal=True, window=0, latency_block=0),
]


def _qkv(seed):
    rng = np.random.default_rng(seed)
    B, T, H, Hkv, D = 2, 16, 4, 2, 8
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, H, D)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_flash_attention_plain_matches_pallas(case):
    q, k, v, tgt = _qkv(1)
    lens = np.asarray(case["lengths"], np.int32) if case["lengths"] is not None else None
    kw = dict(causal=case["causal"], window=case["window"], latency_block=case["latency_block"])

    def loss_j(q, k, v):
        o = jfl.flash_attention(q, k, v, None if lens is None else jnp.asarray(lens), block_q=8,
                                interpret=True, **kw)
        return jnp.sum((o - tgt) ** 2), o

    (_, o_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o_t = tfl.flash_attention(tq, tk, tv, None if lens is None else torch.from_numpy(lens), **kw)
    g_t = torch.autograd.grad(((o_t - torch.from_numpy(tgt)) ** 2).sum(), (tq, tk, tv))
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), rtol=0, atol=2e-5)
    for a, b, name in zip(g_t, g_j, "qkv"):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES[:5], ids=[c["name"] for c in CASES[:5]])
def test_flash_attention_plain_backward_is_autograd_of_forward(case):
    """fp32, on cases where every row sees a key: the explicit backward
    equals autograd through the plain forward."""
    q, k, v, tgt = (torch.from_numpy(x) for x in _qkv(2))
    lens = torch.tensor(case["lengths"]) if case["lengths"] is not None else None
    kw = dict(causal=case["causal"], window=case["window"], latency_block=case["latency_block"])
    grads = []
    for fn in (lambda *a: tfl.flash_attention(*a, **kw),
               lambda *a: tfl.flash_forward_plain(*a, scale=8**-0.5, **kw)):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(((fn(*x, lens) - tgt) ** 2).sum(), x))
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)


def test_flash_attention_rejects_cross_attention():
    q, k = torch.zeros((1, 4, 2, 8)), torch.zeros((1, 6, 2, 8))
    with pytest.raises(ValueError, match="self-attention"):
        tfl.flash_attention(q, k, k)


# --------------------------------------------------------------------------
# LoRA
# --------------------------------------------------------------------------


def _lora_trees(seed=0):
    """A JAX decoder tree with rank-4 LoRA on every decoder target, lora_b
    set away from zero, and the same tree for the port."""
    cfg = jc.DecoderConfig(vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2,
                           num_heads=4, num_kv_heads=2, head_dim=8)
    params = jdec.init_params(cfg, jax.random.key(seed))
    lcfg = jc.LoraConfig(r=4, lora_alpha=8.0, target_modules=tuple(jlora.DECODER_TARGETS))
    params = jlora.add_lora(params, lcfg, jax.random.key(seed + 1), jlora.DECODER_TARGETS)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        if str(p[-1].key) == "lora_b" else a, params)
    return params, _t(jax.tree.map(np.asarray, params))


def test_proj_apply_and_merge_lora_match_jax():
    jp, tp = _lora_trees()
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(np.float32)
    for name in ("q_proj", "down_proj"):
        xin = x if name == "q_proj" else np.random.default_rng(4).standard_normal(
            (2, 5, 64)).astype(np.float32)
        jl = jax.tree.map(lambda a: a[1], jp["layers"][name])
        tl = {k: v[1] for k, v in tp["layers"][name].items()}
        np.testing.assert_allclose(_np(tlora.proj_apply(torch.from_numpy(xin), tl)),
                                   np.asarray(jlora.proj_apply(jnp.asarray(xin), jl)),
                                   rtol=1e-5, atol=1e-5)
    jm = jlora.merge_lora({"language_model": jp})["language_model"]
    tm = tlora.merge_lora({"language_model": tp})["language_model"]
    assert [p for p, _ in _leaves(tm)] == [p for p, _ in _leaves(jax.tree.map(np.asarray, jm))]
    for (p, a), (_, b) in zip(_leaves(tm), _leaves(jax.tree.map(np.asarray, jm))):
        np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=1e-6, err_msg=p)


def test_proj_apply_keeps_the_base_dtype():
    """fp32 adapters over a bf16 base: the output stays bf16."""
    g = torch.Generator().manual_seed(0)
    p = {"kernel": torch.randn((8, 6), generator=g).to(torch.bfloat16),
         "lora_a": torch.randn((8, 2), generator=g), "lora_b": torch.randn((2, 6), generator=g),
         "lora_scale": torch.tensor(2.0)}
    assert tlora.proj_apply(torch.randn((3, 8), generator=g).to(torch.bfloat16), p).dtype == (
        torch.bfloat16)


@pytest.mark.parametrize("targets", [None, ("q_proj", "v_proj"), ("linear_q", "fc1", "o_proj")])
def test_add_lora_leaves_and_targets_match_jax(targets):
    jcfg, tcfg = make_configs()
    jp, tp = make_params(jcfg, tcfg)
    kw = {} if targets is None else dict(target_modules=targets)
    jl = jlora.apply_lora_to_model(jp, jc.LoraConfig(r=3, **kw), jc.LoraConfig(r=4, **kw),
                                   jax.random.key(0))
    tl = tlora.apply_lora_to_model(tp, tc.LoraConfig(r=3, **kw), tc.LoraConfig(r=4, **kw),
                                   torch.Generator().manual_seed(0))
    jleaves = {p: a for p, a in _leaves(jax.tree.map(np.asarray, jl))}
    tleaves = {p: a for p, a in _leaves(tl)}
    assert sorted(jleaves) == sorted(tleaves)
    for p, a in tleaves.items():
        assert tuple(a.shape) == jleaves[p].shape, p
        if p.endswith("lora_b"):
            assert not a.any(), p
        if p.endswith("lora_scale"):
            r = 3 if p.startswith("/language_model") else 4
            assert torch.all(a == 8.0 / r), p


# --------------------------------------------------------------------------
# towers
# --------------------------------------------------------------------------


def _encoder_setup():
    cfg_kw = dict(num_mel_bins=80, d_model=32, num_layers=2, num_heads=2, ffn_dim=64,
                  max_source_positions=64)
    jcfg, tcfg = jc.WhisperEncoderConfig(**cfg_kw), tc.WhisperEncoderConfig(**cfg_kw)
    params = jenc.init_params(jcfg, jax.random.key(0), jnp.float32)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 80, 128)).astype(np.float32)
    lens = np.asarray([128, 70], np.int32)
    return jcfg, tcfg, params, mel, lens


@pytest.mark.parametrize("lat", [None, 16])
def test_encoder_flash_matches_jax(lat):
    jcfg, tcfg, jp, mel, lens = _encoder_setup()

    def loss_j(p):
        o = jenc.encoder_forward(p, jcfg, jnp.asarray(mel), jnp.asarray(lens), attn_impl="xla",
                                 latency_block_size=lat)
        return jnp.sum(o**2), o

    (_, o_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(jp)
    tp = _t(jax.tree.map(np.asarray, jp))
    outs = {}

    def loss_t(p):
        o = tenc.encoder_forward(p, tcfg, torch.from_numpy(mel), torch.from_numpy(lens),
                                 attn_impl="flash", latency_block_size=lat)
        outs["o"] = o
        return (o**2).sum()

    _, g_t = _grads(loss_t, tp)
    np.testing.assert_allclose(_np(outs["o"]), np.asarray(o_j), rtol=0, atol=3e-5)
    for a, b, (p, _) in zip(g_t, jax.tree.leaves(g_j), _leaves(tp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-3, atol=2e-3, err_msg=p)


def test_encoder_remat_changes_nothing():
    _, tcfg, jp, mel, lens = _encoder_setup()
    res = []
    for remat in (False, True):
        tp = _t(jax.tree.map(np.asarray, jp))
        out, g = _grads(lambda p: (tenc.encoder_forward(
            p, tcfg, torch.from_numpy(mel), torch.from_numpy(lens), attn_impl="flash",
            latency_block_size=16, remat=remat) ** 2).sum(), tp)
        res.append((out, g))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)


DECODERS = {
    "llama-gqa": dict(arch="llama", num_heads=4, num_kv_heads=2),
    "mistral-window": dict(arch="mistral", num_heads=2, num_kv_heads=2, sliding_window=8),
    "gemma2-softcap": dict(arch="gemma2", num_heads=2, num_kv_heads=2, sliding_window=8,
                           sliding_window_pattern=2, attn_logit_softcapping=50.0,
                           final_logit_softcapping=30.0, use_post_norms=True,
                           scale_embeddings=True, query_pre_attn_scalar=16.0,
                           hidden_act="gelu_pytorch_tanh"),
}


def _decoder_setup(name):
    kw = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_layers=2, head_dim=16,
              **DECODERS[name])
    jcfg, tcfg = jc.DecoderConfig(**kw), tc.DecoderConfig(**kw)
    params = jdec.init_params(jcfg, jax.random.key(1), jnp.float32)
    rng = np.random.default_rng(2)
    B, T = 2, 24
    ids = rng.integers(1, 96, (B, T)).astype(np.int32)
    lens = np.asarray([T, 17], np.int32)
    return jcfg, tcfg, params, ids, lens


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_flash_matches_jax(name, monkeypatch):
    jcfg, tcfg, jp, ids, lens = _decoder_setup(name)
    B, T = ids.shape
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))

    def loss_j(p):
        o, _ = jdec.decoder_forward(p, jcfg, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos),
                                    kv_valid_len=jnp.asarray(lens))
        return jnp.sum(o**2) * 1e-3, o

    (_, o_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(jp)
    if name == "gemma2-softcap":  # the softcap keeps mha: the kernel must not run
        def no_kernel(*a, **k):
            raise AssertionError("flash_attention called under an attention softcap")
        monkeypatch.setattr(tdec, "flash_attention", no_kernel)
    tp = _t(jax.tree.map(np.asarray, jp))
    outs = {}

    def loss_t(p):
        o, _ = tdec.decoder_forward(p, tcfg, input_ids=torch.from_numpy(ids),
                                    positions=torch.from_numpy(pos.copy()),
                                    kv_valid_len=torch.from_numpy(lens), attn_impl="flash")
        outs["o"] = o
        return (o**2).sum() * 1e-3

    _, g_t = _grads(loss_t, tp)
    np.testing.assert_allclose(_np(outs["o"]), np.asarray(o_j), rtol=1e-4, atol=5e-5)
    for a, b, (p, _) in zip(g_t, jax.tree.leaves(g_j), _leaves(tp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-3, atol=1e-4, err_msg=p)


def test_decoder_remat_changes_nothing_and_attn_impl_is_checked():
    _, tcfg, jp, ids, lens = _decoder_setup("mistral-window")
    pos = torch.arange(ids.shape[1])[None].expand(ids.shape)
    res = []
    for remat in (False, True):
        out, g = _grads(lambda p: tdec.decoder_forward(
            p, tcfg, input_ids=torch.from_numpy(ids), positions=pos,
            kv_valid_len=torch.from_numpy(lens), attn_impl="flash", remat=remat)[0].sum(),
            _t(jax.tree.map(np.asarray, jp)))
        res.append((out, g))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="attn_impl"):
        tdec.decoder_forward(_t(jax.tree.map(np.asarray, jp)), tcfg, input_ids=torch.from_numpy(ids),
                             positions=pos, kv_valid_len=torch.from_numpy(lens), attn_impl="fused")


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _loss_inputs():
    """Logits and hidden states of a 2-row batch, T=12 student and T2=10
    teacher, labels with unequal masked counts (row 0: 5 vs 4) and a row
    with no label in the student stream (row 1)."""
    rng = np.random.default_rng(5)
    B, T, T2, D, V = 2, 12, 10, 16, 40
    labels = np.full((B, T), -100, np.int32)
    labels[0, 6:11] = rng.integers(0, V, 5)
    alt = np.full((B, T2), -100, np.int32)
    alt[0, 5:9] = rng.integers(0, V, 4)
    alt[1, 3:7] = rng.integers(0, V, 4)
    lm = {"embed_tokens": (0.3 * rng.standard_normal((V, D))).astype(np.float32)}
    return dict(
        logits=(2 * rng.standard_normal((B, T, V))).astype(np.float32),
        t_logits=(2 * rng.standard_normal((B, T2, V))).astype(np.float32),
        hidden=rng.standard_normal((B, T, D)).astype(np.float32),
        t_hidden=rng.standard_normal((B, T2, D)).astype(np.float32),
        labels=labels, alt=alt, lm=lm,
    )


def test_losses_match_jax():
    d = _loss_inputs()
    kw = dict(vocab_size=40, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
              num_kv_heads=2, head_dim=8, tie_word_embeddings=True)
    jtc, ttc = jc.DecoderConfig(**kw), tc.DecoderConfig(**kw)
    jlc = jc.LossConfig(loss_function=jc.LossFunction.KL_DIVERGENCE, kl_temperature=2.0)
    tlc = tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE, kl_temperature=2.0)
    J = {k: jnp.asarray(v) for k, v in d.items() if k != "lm"}
    jlm = {"embed_tokens": jnp.asarray(d["lm"]["embed_tokens"])}
    cases = {
        "ce": (lambda x: juv.causal_lm_loss(x["logits"], J["labels"]),
               lambda x: tuv.causal_lm_loss(x["logits"], T["labels"]), "logits"),
        "ce_chunked": (lambda x: juv.causal_lm_loss_chunked(jlm, jtc, x["hidden"], J["labels"], chunk=5),
                       lambda x: tuv.causal_lm_loss_chunked(tlm, ttc, x["hidden"], T["labels"], chunk=5),
                       "hidden"),
        "kl": (lambda x: juv.kl_distillation_loss(x["logits"], J["labels"], J["t_logits"],
                                                  J["alt"], jlc),
               lambda x: tuv.kl_distillation_loss(x["logits"], T["labels"], T["t_logits"],
                                                  T["alt"], tlc), "logits"),
        "kl_chunked": (lambda x: juv.kl_distillation_loss_chunked(
                           jlm, jtc, x["hidden"], J["labels"], J["t_hidden"], J["alt"], jlc, chunk=3),
                       lambda x: tuv.kl_distillation_loss_chunked(
                           tlm, ttc, x["hidden"], T["labels"], T["t_hidden"], T["alt"], tlc, chunk=3),
                       "hidden"),
    }
    for name, (fj, ft, arg) in cases.items():
        T = {k: torch.from_numpy(v) for k, v in d.items() if k != "lm"}
        tlm = {"embed_tokens": torch.from_numpy(d["lm"]["embed_tokens"])}
        lj, gj = jax.value_and_grad(lambda a: fj(dict(J, **{arg: a})))(J[arg])
        T[arg].requires_grad_(True)
        lt = ft(T)
        (gt,) = torch.autograd.grad(lt, T[arg])
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-5, atol=1e-6, err_msg=name)
    for labels in (d["labels"], d["alt"]):
        for a, b in zip(tuv.prediction_masks(torch.from_numpy(labels)),
                        juv.prediction_masks(jnp.asarray(labels))):
            assert np.array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

TRAINABLE = (r".*projector/.*", r".*audio_tower/.*lora_[ab]$")


def _train_batch(cfg):
    """The parity fixtures' audio batch plus labels and the text-only
    teacher stream (T2 = 20), with unequal masked counts in row 1."""
    b = audio_batch(jmel.log_mel_spectrogram_np, cfg.audio_token_compression)
    B, T = b["input_ids"].shape
    rng = np.random.default_rng(7)
    labels = np.full((B, T), -100, np.int32)
    labels[0, 20:32] = b["input_ids"][0, 20:32]
    labels[1, 20:28] = b["input_ids"][1, 20:28]
    T2 = 20
    alt_ids = rng.integers(1, 512, (B, T2)).astype(np.int32)
    alt_mask = np.ones((B, T2), np.int32)
    alt_mask[1, 18:] = 0
    alt_labels = np.full((B, T2), -100, np.int32)
    alt_labels[0, 8:20] = labels[0, 20:32]
    alt_labels[1, 8:15] = labels[1, 21:28]
    return dict(b, labels=labels, alt_input_ids=alt_ids, alt_attention_mask=alt_mask,
                alt_labels=alt_labels)


@pytest.fixture(scope="module")
def train_setup():
    jcfg, tcfg = make_configs()
    jp, _ = make_params(jcfg, tcfg)
    jp = jlora.apply_lora_to_model(jp, jc.LoraConfig(), jc.LoraConfig(
        r=4, target_modules=("q_proj", "v_proj")), jax.random.key(3))
    rng = np.random.default_rng(9)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype)
        if str(p[-1].key) == "lora_b" else a, jp)
    return jcfg, tcfg, jp, _train_batch(tcfg)


def test_train_step_matches_jax(train_setup):
    """Two KL steps, remat, vocab_chunk=16: loss, grad_norm and param_norm
    of each step within rtol 1e-5; frozen leaves bit-identical; the updated
    trainable leaves within 1e-5 absolute where the clipped JAX gradient
    exceeds 1e-7 (10 x Adam's eps) in magnitude, over 90% of the elements.
    (Adam moves an element by about lr g / (|g| + eps) in its first steps,
    so an element whose gradient is near eps or rounding noise may differ by
    up to 2 lr between the frameworks; those are left out.)"""
    jcfg, tcfg, jp, batch = train_setup
    opt_kw = dict(warmup_steps=1, total_steps=10, weight_decay=0.01, max_grad_norm=0.05)
    jlc = jc.LossConfig(loss_function=jc.LossFunction.KL_DIVERGENCE)
    tlc = tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE)

    jopt = jts.make_optimizer(1e-3, **opt_kw)
    jstate, jtemplate = jts.init_train_state(jp, jopt, TRAINABLE)
    jstep = jax.jit(jts.make_train_step(jcfg, jlc, jopt, jtemplate, remat=True,
                                        attn_impl="xla", vocab_chunk=16))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    for _ in range(2):
        jstate, m = jstep(jstate, jbatch)
        jmetrics.append({k: float(v) for k, v in m.items()})
    # the step-0 gradient (the lr of update 0 is 0, so step 1 sees the same
    # parameters and the same gradient)
    jgrads = jax.grad(lambda tr: juv.ultravox_loss(
        jts.merge_params(jtemplate, tr, jts.init_train_state(jp, jopt, TRAINABLE)[0].frozen),
        jcfg, jbatch, jlc, remat=True, vocab_chunk=16))(
        jts.init_train_state(jp, jopt, TRAINABLE)[0].trainable)

    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    topt = tts.make_optimizer(1e-3, **opt_kw)
    tstate, ttemplate = tts.init_train_state(tp, topt, TRAINABLE, device="cpu")
    frozen0 = {k: v.clone() for k, v in tstate.frozen.items()}
    tstep = tts.make_train_step(tcfg, tlc, topt, ttemplate, remat=True, attn_impl="flash",
                                vocab_chunk=16)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(2):
        tstate, m = tstep(tstate, tbatch)
        for k in ("loss", "grad_norm", "param_norm"):
            assert m[k].shape == ()
            np.testing.assert_allclose(float(m[k]), jmetrics[i][k], rtol=1e-5, err_msg=f"{k} {i}")
    assert jmetrics[0]["grad_norm"] > opt_kw["max_grad_norm"]  # clipping ran
    assert tstate.step == 2 and int(jstate.step) == 2
    assert sorted(tstate.trainable) == sorted(jstate.trainable)
    assert any("lora_a" in k for k in tstate.trainable)
    for k, v in tstate.frozen.items():
        assert torch.equal(v, frozen0[k]), k
    clip = opt_kw["max_grad_norm"] / jmetrics[0]["grad_norm"]
    compared = 0
    for k, v in tstate.trainable.items():
        big = np.abs(np.asarray(jgrads[k])) * clip > 1e-7  # the gradient Adam sees
        compared += big.sum()
        np.testing.assert_allclose(_np(v)[big], np.asarray(jstate.trainable[k])[big],
                                   rtol=0, atol=1e-5, err_msg=k)
    assert compared > 0.9 * sum(v.numel() for v in tstate.trainable.values())

    jeval = jts.make_eval_step(jcfg, jlc, jtemplate, vocab_chunk=16)(jstate, jbatch)
    for chunk in (16, None):
        s, c = tts.make_eval_step(tcfg, tlc, ttemplate, vocab_chunk=chunk, attn_impl="flash")(
            tstate, tbatch)
        np.testing.assert_allclose(float(s), float(jeval[0]), rtol=1e-4)
        assert int(c) == int(jeval[1])


def test_partition_round_trips_with_jax_paths(train_setup):
    jcfg, tcfg, jp, _ = train_setup
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    jtr, jfr = jts.partition_params(jp, jts.trainable_mask(jp, TRAINABLE))
    ttr, tfr = tts.partition_params(tp, tts.trainable_mask(tp, TRAINABLE))
    assert list(ttr) == list(jtr) and list(tfr) == list(jfr)
    assert "audio_tower/layers/q_proj/lora_a" in ttr and "audio_tower/layers/k_proj/kernel" in tfr
    template = jax.tree.map(lambda a: (a.shape, a.dtype), tp,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    merged = tts.merge_params(template, ttr, tfr)
    assert [p for p, _ in _leaves(merged)] == [p for p, _ in _leaves(tp)]
    assert all(a is b for (_, a), (_, b) in zip(_leaves(merged), _leaves(tp)))


@pytest.mark.parametrize("schedule", ["cosine_with_min_lr", "constant", "linear"])
def test_optimizer_schedule_and_update_match_optax(schedule):
    """With a constant gradient of 1 and no clipping or decay, Adam's update
    n is -lr(n) / (1 + 1e-8): optax's lr for steps 0-12, read off its
    updates, equals the port's schedule and the port's AdamW updates, to
    rtol 1e-5 (optax's bias corrections and schedule run in fp32)."""
    kw = dict(schedule=schedule, warmup_steps=3, total_steps=10, max_grad_norm=0.0)
    jopt = jts.make_optimizer(1e-2, **kw)
    topt = tts.make_optimizer(1e-2, **kw)
    p = jnp.zeros((3,))
    s = jopt.init(p)
    tp = torch.zeros(3, requires_grad=True)
    adam = topt.init({"p": tp})
    for n in range(13):
        u, s = jopt.update(jnp.ones(3), s, p)
        before = tp.detach().clone()
        topt.update(adam, [tp], [torch.ones(3)], torch.tensor(3.0**0.5))
        assert adam.count == n + 1  # the schedule counts updates
        lr_j = -float(u[0]) * (1 + 1e-8)
        np.testing.assert_allclose(topt.schedule(n), lr_j, rtol=1e-5, atol=1e-12, err_msg=str(n))
        np.testing.assert_allclose(_np(tp - before), np.asarray(u), rtol=1e-5, atol=1e-12)
