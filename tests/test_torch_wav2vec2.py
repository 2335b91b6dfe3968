"""The port's wav2vec2 tower against the JAX package's, on the CPU.

Tiny configs in both norm styles (``tests/torch_parity.py::w2v_hf_dict``:
hidden 64, 2 layers, convs (32, 32, 32) with kernels (10, 3, 2) and strides
(5, 2, 2), a positional conv of 16 taps in 4 groups), seeded numpy inputs,
fp32, JAX at ``highest`` matmul precision (tests/conftest.py):

- the config (``from_hf_dict``, ``feature_lengths``, ``min_samples``,
  ``audio_arch``), also for the two published configs the chip run uses;
- ``feature_extractor``, the positional conv (odd and even kernel) and
  ``encoder_forward`` with and without ragged ``sample_lens``, within rtol =
  atol = 1e-5; each row of the stable variant alone equal to its row of the
  padded batch;
- ``convert_wav2vec2_encoder`` from an HF-layout state dict in both
  weight-norm key forms and through ``Wav2Vec2ForCTC``'s ``wav2vec2.``
  prefix, leaf for leaf against the JAX converter (which the JAX package's
  tests hold against transformers' model), the overlay and
  ``_covers_encoder`` on a diff dict, ``config_to_hf_dict`` and
  ``_wav2vec2_to_hf`` against JAX's with the round trip;
- the list in the tree through ``from_jax_params``, ``_to_device`` and the
  train step's path walkers (JAX's paths and order);
- the engines' gates (no fused or int8 wav2vec2 tower, also when "auto"
  resolves to the card's choices), ``tower_dtype``, and the audio LoRA that
  the JAX package silently ignores and the port refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import W2V_STYLES, make_w2v_configs, make_w2v_params, w2v_hf_dict
from ultravox_torch.inference.engine import GenerationEngine, _to_device
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.inference.serving.api_server import tower_dtype
from ultravox_torch.models import config as tc
from ultravox_torch.models import lora as tlora
from ultravox_torch.models import wav2vec2_encoder as tw
from ultravox_torch.models import weights as tweights
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.tools import publish as tpublish
from ultravox_torch.training import train_step as tts
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import lora as jlora
from ultravox_tpu.models import wav2vec2_encoder as jw
from ultravox_tpu.models import weights as jweights
from ultravox_tpu.tools import publish as jpublish
from ultravox_tpu.training import train_step as jts

TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX functions compiled whole (a config is static): faster on the CPU
# than op by op
_jfeat = jax.jit(jw.feature_extractor, static_argnums=1)
_jpos = jax.jit(jw._pos_conv_embedding, static_argnums=1)
_jenc = jax.jit(jw.encoder_forward, static_argnums=1)

# the published configs of phase 13 of chip_smoke.py, as their config.json
# files give them: facebook/wav2vec2-large-960h-lv60-self and
# facebook/wav2vec2-base-960h
LARGE_LV60 = dict(
    model_type="wav2vec2", hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
    intermediate_size=4096, conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=True, feat_extract_norm="layer",
    do_stable_layer_norm=True, num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
    layer_norm_eps=1e-5)
BASE = dict(LARGE_LV60, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_bias=False, feat_extract_norm="group",
            do_stable_layer_norm=False)


def _tree(params):
    """A JAX tree (dicts and the conv list) as torch tensors."""
    return from_jax_params(jax.tree.map(np.asarray, params), None)


def _tower(style, pos_taps=16):
    """(JAX config, port config, JAX tower params, the same as port params)."""
    d = w2v_hf_dict(style, pos_taps)
    jcfg = jw.Wav2Vec2EncoderConfig.from_hf_dict(d)
    tcfg = tw.Wav2Vec2EncoderConfig.from_hf_dict(d)
    jp = jw.init_params(jcfg, jax.random.key(1))
    # non-trivial norms and biases: a dropped bias or scale must show
    rng = np.random.default_rng(1)
    jp = jax.tree.map(
        lambda a: a * 2 if a.ndim >= 2 else a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jp)
    return jcfg, tcfg, jp, _tree(jp)


def _audio(rows=2, n=4000, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(np.float32)


@pytest.mark.parametrize("d", [LARGE_LV60, BASE] + [w2v_hf_dict(s) for s in W2V_STYLES],
                         ids=["large-lv60", "base", "tiny-group", "tiny-layer"])
def test_config_matches_jax(d):
    j, t = jw.Wav2Vec2EncoderConfig.from_hf_dict(d), tw.Wav2Vec2EncoderConfig.from_hf_dict(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tc.make_audio_config(d) == t and type(t).__name__ == "Wav2Vec2EncoderConfig"
    for name in ("d_model", "head_dim", "downsample_factor", "min_samples"):
        assert getattr(t, name) == getattr(j, name), name
    lens = np.array([400, 401, 4000, 16000, 160000, 117000])
    np.testing.assert_array_equal(t.feature_lengths(lens), j.feature_lengths(lens))
    np.testing.assert_array_equal(t.feature_lengths(torch.from_numpy(lens)).numpy(),
                                  j.feature_lengths(lens))
    assert t.feature_lengths(t.min_samples) == 1 and t.feature_lengths(t.min_samples - 1) <= 0
    if d is LARGE_LV60:
        assert (t.min_samples, t.downsample_factor, t.feature_lengths(160000)) == (400, 320, 499)
    outer = {"audio_config": d, "text_config": {"model_type": "llama"}, "stack_factor": 8}
    tu, ju = tc.UltravoxConfig.from_hf_dict(outer), jc.UltravoxConfig.from_hf_dict(outer)
    assert tu.audio_arch == ju.audio_arch == "wav2vec2"
    assert tu.audio_config == t and tu.audio_token_compression == ju.audio_token_compression
    assert tc.UltravoxConfig().audio_arch == "whisper"


@pytest.mark.parametrize("pos_taps", [16, 15], ids=["even", "odd"])
@pytest.mark.parametrize("style", W2V_STYLES)
def test_feature_extractor_and_pos_conv_match_jax(style, pos_taps):
    jcfg, tcfg, jp, tp = _tower(style, pos_taps)
    audio = _audio()
    got = tw.feature_extractor(tp, tcfg, torch.from_numpy(audio)).numpy()
    want = np.asarray(_jfeat(jp, jcfg, jnp.asarray(audio)))
    assert got.shape == want.shape == (2, 199, 32)
    np.testing.assert_allclose(got, want, **TOL)
    h = np.random.default_rng(2).standard_normal((2, 37, 64)).astype(np.float32)
    got = tw.pos_conv_embedding(tp, tcfg, torch.from_numpy(h)).numpy()
    want = np.asarray(_jpos(jp, jcfg, jnp.asarray(h)))
    assert got.shape == want.shape == h.shape  # the even kernel's extra frame trimmed
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("style", W2V_STYLES)
def test_encoder_forward_matches_jax(style, ragged):
    jcfg, tcfg, jp, tp = _tower(style)
    audio = _audio(3, 4000)
    lens = np.array([4000, 2500, 401], np.int32) if ragged else None
    got = tw.encoder_forward(tp, tcfg, torch.from_numpy(audio),
                             None if lens is None else torch.from_numpy(lens)).numpy()
    want = np.asarray(_jenc(jp, jcfg, jnp.asarray(audio),
                            None if lens is None else jnp.asarray(lens)))
    assert got.shape == want.shape == (3, 199, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_stable_row_alone_equals_its_padded_row():
    """The layer variant: frames past a row's length are zeroed before the
    positional conv and masked in attention, and every norm is per frame,
    so a row alone gives its valid frames of the padded batch. (The group
    variant's first GroupNorm takes statistics over the padded time axis,
    in the JAX package and in HF alike, so padding moves it.)"""
    _, tcfg, _, tp = _tower("layer")
    audio = _audio(3, 4000, seed=3)
    lens = [4000, 2500, 401]
    for i, n in enumerate(lens):
        audio[i, n:] = 0.0
    batch = tw.encoder_forward(tp, tcfg, torch.from_numpy(audio), torch.tensor(lens))
    for i, n in enumerate(lens):
        alone = tw.encoder_forward(tp, tcfg, torch.from_numpy(audio[i: i + 1, :n]))
        frames = int(tcfg.feature_lengths(n))
        assert alone.shape[1] == frames
        np.testing.assert_allclose(batch[i, :frames].numpy(), alone[0].numpy(), **TOL)


def _hf_state_dict(style, form="parametrizations"):
    """An HF Wav2Vec2Model-layout state dict of the tiny config (seeded
    random values, the key names transformers gives), its weight norm in
    the parametrizations key form or the older weight_g / weight_v."""
    jcfg = jw.Wav2Vec2EncoderConfig.from_hf_dict(w2v_hf_dict(style))
    jp = jw.init_params(jcfg, jax.random.key(3))
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), jp)
    ucfg = jc.UltravoxConfig(audio_config=jcfg)
    sd = {k: np.array(v) for k, v in jpublish._wav2vec2_to_hf(jp, ucfg).items()}
    pc = "encoder.pos_conv_embed.conv."
    g, v = sd.pop(pc + "weight_g"), sd.pop(pc + "weight_v")
    sd[pc + "weight_g"] = g * np.exp(0.1 * rng.standard_normal(g.shape)).astype(np.float32)
    sd[pc + "weight_v"] = v
    if form == "parametrizations":
        sd[pc + "parametrizations.weight.original0"] = sd.pop(pc + "weight_g")
        sd[pc + "parametrizations.weight.original1"] = sd.pop(pc + "weight_v")
    return sd


def _assert_trees_equal(got, want, exact=True, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], exact, f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_trees_equal(a, b, exact, f"{path}/{i}")
    else:
        a, b = got.detach().numpy(), np.asarray(want)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=path)


@pytest.mark.parametrize("form", ["parametrizations", "weight_g"])
@pytest.mark.parametrize("style", W2V_STYLES)
def test_convert_matches_jax(style, form):
    sd = _hf_state_dict(style, form)
    assert (form == "weight_g") == any(k.endswith("weight_g") for k in sd)
    tcfg = tw.Wav2Vec2EncoderConfig.from_hf_dict(w2v_hf_dict(style))
    jcfg = jw.Wav2Vec2EncoderConfig.from_hf_dict(w2v_hf_dict(style))
    got = tweights.convert_wav2vec2_encoder({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    want = jweights.convert_wav2vec2_encoder(sd, jcfg)
    assert isinstance(got["feature_extractor"], list)
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))


def test_tower_checkpoint_prefix_and_bf16():
    """Wav2Vec2ForCTC nests the tower under ``wav2vec2.`` beside its
    ``lm_head``; a Whisper-shaped state dict gives None; bf16 leaves as the
    JAX converter's."""
    sd = {f"wav2vec2.{k}": v for k, v in _hf_state_dict("layer").items()}
    sd["lm_head.weight"] = np.zeros((32, 64), np.float32)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tcfg = tw.Wav2Vec2EncoderConfig.from_hf_dict(w2v_hf_dict("layer"))
    jcfg = jw.Wav2Vec2EncoderConfig.from_hf_dict(w2v_hf_dict("layer"))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tweights.convert_audio_tower_checkpoint(tsd, tcfg, dt)
        want = jweights.convert_audio_tower_checkpoint(sd, jcfg, jdt)
        flat_t = list(tts._path_items(got))
        flat_j = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_t] == [jts._path_str(p) for p, _ in flat_j]
        for (p, a), (_, b) in zip(flat_t, flat_j):
            assert a.dtype == dt, p
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32), err_msg=p)
    assert tweights.convert_audio_tower_checkpoint({"conv1.weight": torch.zeros(1)}, tcfg) is None


def test_overlay_and_covers_match_jax():
    jcfg, tcfg = make_w2v_configs("group")
    jp, tp = make_w2v_params(jcfg, tcfg)
    assert tweights._covers_encoder(_hf_state_dict("group"), tcfg.audio_config)
    rng = np.random.default_rng(1)
    new_kernel = rng.standard_normal((64, 64)).astype(np.float32)
    diff = {
        "audio_tower.encoder.layers.1.attention.q_proj.weight": new_kernel.T.copy(),
        "audio_tower.encoder.layers.1.attention.q_proj.bias": np.ones(64, np.float32),
        "audio_tower.encoder.layer_norm.weight": np.full(64, 2.0, np.float32),
        "audio_tower.feature_projection.projection.weight":
            rng.standard_normal((64, 32)).astype(np.float32),
        "audio_tower.feature_extractor.conv_layers.0.conv.weight": np.zeros((32, 1, 10), np.float32),
    }
    tdiff = {k: torch.from_numpy(v) for k, v in diff.items()}
    assert not tweights._covers_encoder(tweights._strip_prefix(tdiff, "audio_tower."),
                                        tcfg.audio_config)
    got = tweights.convert_ultravox(tdiff, tcfg, torch.float32, base=tp)
    want = jweights.convert_ultravox(diff, jcfg, jnp.float32, base=jp)
    _assert_trees_equal(got["audio_tower"], jax.tree.map(np.asarray, want["audio_tower"]))
    q = got["audio_tower"]["layers"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(q[1].numpy(), new_kernel)
    np.testing.assert_array_equal(q[0].numpy(), tp["audio_tower"]["layers"]["q_proj"]["kernel"][0])
    assert got["audio_tower"]["feature_extractor"] is tp["audio_tower"]["feature_extractor"]
    assert not torch.equal(tp["audio_tower"]["layers"]["q_proj"]["kernel"][1], q[1])  # base kept


@pytest.mark.parametrize("style", W2V_STYLES)
def test_publish_matches_jax_and_round_trips(style):
    jcfg, tcfg = make_w2v_configs(style)
    jp, tp = make_w2v_params(jcfg, tcfg)
    assert tpublish.config_to_hf_dict(tcfg) == jpublish.config_to_hf_dict(jcfg)
    assert tc.UltravoxConfig.from_hf_dict(tpublish.config_to_hf_dict(tcfg)) == tcfg
    got = tpublish._wav2vec2_to_hf(tp["audio_tower"], tcfg)
    want = jpublish._wav2vec2_to_hf(jp["audio_tower"], jcfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        a = got[k].numpy()
        assert a.shape == v.shape and a.dtype == v.dtype, k
        if k.endswith("weight_g"):  # the port takes the norm in float64
            np.testing.assert_allclose(a, v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, v, err_msg=k)
    back = tweights.convert_wav2vec2_encoder(got, tcfg.audio_config)
    _assert_trees_equal(back, jax.tree.map(np.asarray, jp["audio_tower"]), exact=False)


def test_list_in_the_tree_through_every_walker():
    """from_jax_params, _to_device and the train step's walkers carry the
    conv list: the paths (a list index as its number) and their order are
    the JAX package's, so trainable_mask selects the same leaves."""
    jcfg, tcfg = make_w2v_configs("layer")
    jp, tp = make_w2v_params(jcfg, tcfg)
    assert isinstance(tp["audio_tower"]["feature_extractor"], list)
    moved = _to_device(tp, "cpu")
    assert isinstance(moved["audio_tower"]["feature_extractor"], list)
    patterns = (r".*projector/.*", r".*audio_tower/feature_extractor/0/.*",
                r".*audio_tower/layers/fc1/.*")
    ttr, tfr = tts.partition_params(tp, tts.trainable_mask(tp, patterns))
    jtr, jfr = jts.partition_params(jp, jts.trainable_mask(jp, patterns))
    assert list(ttr) == list(jtr) and list(tfr) == list(jfr)
    assert "audio_tower/feature_extractor/0/kernel" in ttr
    assert "audio_tower/feature_extractor/2/norm/scale" in tfr
    template = tts._map_paths(lambda _, v: (tuple(v.shape), v.dtype), tp)
    merged = tts.merge_params(template, ttr, tfr)
    assert [p for p, _ in tts._path_items(merged)] == list(jts.partition_params(
        jp, jts.trainable_mask(jp, ()))[1])
    assert all(a is b for (_, a), (_, b) in zip(tts._path_items(merged), tts._path_items(tp)))


def _same_tree(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(tts._path_items(a), tts._path_items(b)))


def test_engines_neither_fuse_nor_quantise_the_tower(monkeypatch):
    """GenerationEngine with quantize="int8" and the fused encoder keeps the
    wav2vec2 tower as it was (the JAX engines touch only a conv1 tower), and
    so does a ServingEngine whose "auto" options resolve as on the card
    (the fused encoder, the decode and prefill kernels)."""
    _, tcfg = make_w2v_configs("layer")
    _, tp = make_w2v_params(make_w2v_configs("layer")[0], tcfg)
    eng = GenerationEngine(tp, tcfg, quantize="int8", encoder_attn_impl="fused",
                           cache_dtype=torch.float32, device="cpu")
    assert _same_tree(eng.params["audio_tower"], tp["audio_tower"])
    assert "kernel_q" in eng.params["language_model"]["layers"]["qkv_proj"]
    orig = tserve._resolve_auto
    monkeypatch.setattr(tserve, "_resolve_auto",
                        lambda *a: orig(*a[:-1], True))  # as on the card
    srv = tserve.ServingEngine(tp, tcfg, max_seq_len=1024, cache_dtype=torch.float32,
                               device="cpu")
    assert srv.resolved_flags["encoder_attn_impl"] == "fused"
    assert _same_tree(srv.params["audio_tower"], tp["audio_tower"])
    assert srv.mel_len_buckets == tserve.SAMPLE_LEN_BUCKETS  # samples, 4 to 30 s


def test_tower_dtype_of_both_towers():
    _, tcfg = make_w2v_configs("group")
    from ultravox_torch.models import ultravox as tuv

    for cfg in (tcfg, tc.UltravoxConfig(audio_config=tc.WhisperEncoderConfig(
            d_model=32, num_layers=1, num_heads=2, ffn_dim=64),
            text_config=tcfg.text_config, hidden_size=64)):
        params = tuv.init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
        assert tower_dtype(params["audio_tower"]) == torch.bfloat16


def test_audio_lora_ignored_by_jax_refused_by_the_port():
    """JAX's add_lora puts lora_a / lora_b on the wav2vec2 tower's
    projections, and its tower multiplies by the kernels alone: with
    lora_b non-zero the output does not move. The port raises instead, for
    an audio LoRA on such a tower, for a tree carrying one, and for encoder
    adapter banks in the ServingEngine."""
    jcfg, tcfg = make_w2v_configs("layer")
    jp, tp = make_w2v_params(jcfg, tcfg)
    lcfg = jc.LoraConfig(r=4, target_modules=("q_proj", "v_proj", "fc1"))
    jl = jlora.apply_lora_to_model(jp, jc.LoraConfig(), lcfg, jax.random.key(2))
    layers = dict(jl["audio_tower"]["layers"])
    for name in ("q_proj", "v_proj", "fc1"):
        proj = dict(layers[name])
        proj["lora_b"] = jnp.ones_like(proj["lora_b"])
        layers[name] = proj
    adapted = dict(jl["audio_tower"], layers=layers)
    audio = jnp.asarray(_audio(1, 4000))
    np.testing.assert_array_equal(
        np.asarray(_jenc(adapted, jcfg.audio_config, audio)),
        np.asarray(_jenc(jp["audio_tower"], jcfg.audio_config, audio)))

    with pytest.raises(ValueError, match="wav2vec2"):
        tlora.apply_lora_to_model(tp, tc.LoraConfig(), tc.LoraConfig(r=4),
                                  torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="LoRA"):
        tw.encoder_forward(_tree(adapted), tcfg.audio_config, torch.from_numpy(np.array(audio)))
    tl = tlora.add_lora(tp["audio_tower"], tc.LoraConfig(r=4, target_modules=("q_proj",)),
                        torch.Generator().manual_seed(0), tlora.ENCODER_TARGETS)
    with pytest.raises(ValueError, match="wav2vec2"):
        tserve.ServingEngine(tp, tcfg, max_seq_len=128, cache_dtype=torch.float32, device="cpu",
                             lora_adapters={"a": {"audio_tower": tl}})
