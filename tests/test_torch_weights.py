"""The port's checkpoint reader, converters, loader and writer on the CPU,
against the ``safetensors`` package and the JAX package.

The hand-written safetensors reader is bit-equal to the ``safetensors``
package for every dtype it takes (0-d and empty tensors, metadata, sharded
checkpoints through an index, an unaligned offset), and the package reads
the port's writer back. ``tests/assets/tiny_ultravox/`` loads bit for bit
equal to ``expected_params.npz`` and to JAX's ``convert_ultravox``, in fp32
and in bf16 bits (from fp32, fp16 and bf16 files). The cases of
tests/test_loading.py are mirrored against JAX's
``load_ultravox_checkpoint`` with the leaves left at random init out of the
comparison, and the decoder families' checkpoints (gemma-2/3 norms and
softcaps, qwen-2 biases, qwen-3 norms, tied embeddings) load equal.
``save_pretrained`` round-trips bit-equal and writes JAX's config dict, and
the loaded tiny checkpoint's logits match JAX's within 1e-4.
"""

import json
import os
import struct
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ultravox_torch.inference import ultravox_infer as tinfer
from ultravox_torch.models import config as tc
from ultravox_torch.models import lora as tlora
from ultravox_torch.models import ultravox as tuv
from ultravox_torch.models import weights as tw
from ultravox_torch.tools import publish as tpub
from ultravox_torch.utils import wandb_utils
from ultravox_tpu.inference import ultravox_infer as jinfer
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.models import weights as jw
from ultravox_tpu.tools import publish as jpub

FIXTURE = os.path.join(os.path.dirname(__file__), "assets", "tiny_ultravox")
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a numpy array (shape kept)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _jbits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return _bits(a)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tensors(dtype, seed=0):
    """Tensors of one dtype: 2-d, 1-d, 0-d and empty."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        make = lambda *s: torch.rand(s, generator=g) < 0.5  # noqa: E731
    elif dtype.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    else:
        lo = 0 if dtype == torch.uint8 else -100
        make = lambda *s: torch.randint(lo, 100, s, generator=g).to(dtype)  # noqa: E731
    return {"w.mat": make(5, 7), "w.vec": make(11), "w.scalar": make(), "w.empty": make(0, 3)}


def _same(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
    assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("code", list(DTYPES))
def test_reader_and_writer_match_safetensors(tmp_path, code):
    """The port reads the package's file bit for bit (a header with
    metadata), and the package reads the port's file bit for bit."""
    from safetensors.torch import load_file, save_file

    ts = _tensors(DTYPES[code])
    save_file(ts, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = tw.read_safetensors(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(ts)
    for k in ts:
        _same(got[k], ts[k])
    tw.save_safetensors(ts, str(tmp_path / "b.safetensors"))
    back = load_file(str(tmp_path / "b.safetensors"))
    for k in ts:
        _same(back[k], ts[k])


def test_sharded_checkpoints_read_through_the_index(tmp_path):
    """Two shards written by the package with an index load as one dict
    (a stray file the index does not name is ignored); the port's three
    shards and index load back, and the package reads each shard."""
    from safetensors.torch import load_file, save_file

    a, b = _tensors(torch.float32, 1), _tensors(torch.bfloat16, 2)
    b = {k.replace("w.", "v."): v for k, v in b.items()}
    d = tmp_path / "pkg"
    d.mkdir()
    save_file(a, str(d / "model-00001-of-00002.safetensors"))
    save_file(b, str(d / "model-00002-of-00002.safetensors"))
    save_file({"stray": torch.zeros(2)}, str(d / "other.safetensors"))
    wm = {k: "model-00001-of-00002.safetensors" for k in a}
    wm.update({k: "model-00002-of-00002.safetensors" for k in b})
    (d / tw.INDEX_FILE).write_text(json.dumps({"metadata": {}, "weight_map": wm}))
    got = tw.load_safetensors_dir(str(d))
    assert sorted(got) == sorted({**a, **b})
    for k, v in {**a, **b}.items():
        _same(got[k], v)
    sd = {**a, **b}
    tw.save_safetensors_dir(sd, str(tmp_path / "port"), shards=3)
    files = sorted(f for f in os.listdir(tmp_path / "port") if f.endswith(".safetensors"))
    assert files == [f"model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)]
    back = tw.load_safetensors_dir(str(tmp_path / "port"))
    pkg = {}
    for f in files:
        pkg.update(load_file(str(tmp_path / "port" / f)))
    for k, v in sd.items():
        _same(back[k], v)
        _same(pkg[k], v)


def test_unaligned_offsets_and_bad_headers(tmp_path):
    """A tensor whose data starts off its element size (a legal layout the
    package never writes) is copied and read right; offsets that do not
    match the shape raise."""
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    header = {"u": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "f": {"dtype": "F32", "shape": [2, 3], "data_offsets": [3, 27]}}
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(hb)) + hb + bytes([1, 2, 3]) + vals.tobytes())
    got = tw.read_safetensors(str(path))
    assert got["u"].tolist() == [1, 2, 3] and np.array_equal(got["f"].numpy(), vals)
    header["f"]["shape"] = [3, 3]
    hb = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(hb)) + hb + bytes([1, 2, 3]) + vals.tobytes())
    with pytest.raises(ValueError, match="offsets"):
        tw.read_safetensors(str(path))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _compare(jtree, ttree, skip=()):
    """Every leaf of the JAX tree (or a port tree) not under a ``skip``
    prefix is bit-equal (dtype and shape too) to the port's."""
    jf, tf = _flat(jtree), _flat(ttree)
    assert sorted(jf) == sorted(tf)
    n = 0
    for k, v in jf.items():
        if any(k.startswith(s) for s in skip):
            continue
        a, b = _jbits(v), _bits(tf[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
        n += 1
    assert n, "nothing compared"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_checkpoint_loads_like_the_reference(dtype):
    """load_ultravox_checkpoint on the committed checkpoint: fp32 equals
    expected_params.npz, and either dtype equals JAX's convert_ultravox of
    the same files, bit for bit."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    cfg, params, d = tinfer.load_ultravox_checkpoint(FIXTURE, tdt, device="cpu")
    assert d == FIXTURE and cfg == tc.UltravoxConfig.from_pretrained_dir(FIXTURE)
    jcfg = jc.UltravoxConfig.from_pretrained_dir(FIXTURE)
    _compare(jw.convert_ultravox(jw.load_safetensors_dir(FIXTURE), jcfg, jdt), params)
    if dtype == "float32":
        expected = dict(np.load(os.path.join(FIXTURE, "expected_params.npz")))
        got = _flat(params)
        assert sorted(got) == sorted(expected)
        for k, v in expected.items():
            assert np.array_equal(_bits(got[k]), v), k


@pytest.mark.parametrize("src", ["float16", "bfloat16"])
def test_half_files_cast_like_the_reference(tmp_path, src):
    """The port casts fp16 and bf16 leaves to bf16 directly; the reference
    reads them as fp32 and then casts. The bits are the same."""
    sd = tw.load_safetensors_dir(FIXTURE)
    tw.save_safetensors({k: v.to(getattr(torch, src)) for k, v in sd.items()},
                        str(tmp_path / "model.safetensors"))
    cfg = tc.UltravoxConfig.from_pretrained_dir(FIXTURE)
    got = tw.convert_ultravox(tw.load_safetensors_dir(str(tmp_path)), cfg, torch.bfloat16)
    wide = {k: v.to(getattr(torch, src)).float().numpy() for k, v in sd.items()}
    want = jw.convert_ultravox(wide, jc.UltravoxConfig.from_pretrained_dir(FIXTURE), jnp.bfloat16)
    _compare(want, got)


def test_forward_logits_match_jax():
    """ultravox_forward on the loaded tiny checkpoint: fp32 logits within
    1e-4 of JAX's on the reference's own load."""
    _, params, _ = tinfer.load_ultravox_checkpoint(FIXTURE, torch.float32, device="cpu")
    jcfg, jparams, _ = jinfer.load_ultravox_checkpoint(FIXTURE, jnp.float32)
    cfg = tc.UltravoxConfig.from_pretrained_dir(FIXTURE)
    ids = (np.arange(24, dtype=np.int32)[None] * 37) % 300
    mask = np.ones_like(ids)
    mask[0, 20:] = 0
    want = np.asarray(juv.ultravox_forward(
        jparams, jcfg, {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}))
    with torch.no_grad():
        got = tuv.ultravox_forward(
            params, cfg, {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[0, :20], want[0, :20], atol=1e-4, rtol=0)


# -- the cases of tests/test_loading.py, against JAX's loader ---------------


def _tiny_cfgs(**kw):
    def mk(c):
        return c.UltravoxConfig(
            audio_config=c.WhisperEncoderConfig(d_model=32, num_layers=2, num_heads=2, ffn_dim=64),
            text_config=c.DecoderConfig(vocab_size=384, hidden_size=48, intermediate_size=96,
                                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=12),
            hidden_size=64, **kw)

    return mk(jc), mk(tc)


def _write_base_dirs(tmp_path, jcfg, params):
    """Standalone text / audio base checkpoints in HF naming, written by
    the port's writer from the reverse converters."""
    text_dir, audio_dir = tmp_path / "text_base", tmp_path / "audio_base"
    tparams = _to_port(params)
    tcfg = _tiny_cfgs()[1]
    tw.save_safetensors_dir(tw.decoder_to_hf(tparams["language_model"], tcfg.text_config),
                            str(text_dir))
    tw.save_safetensors_dir(tpub._encoder_to_hf(tparams["audio_tower"], tcfg), str(audio_dir))
    return str(text_dir), str(audio_dir)


def _to_port(jparams):
    return tw.from_jax_params(jax.tree.map(np.asarray, jparams), _tiny_cfgs()[1])


@pytest.fixture(scope="module")
def trees():
    jcfg, _ = _tiny_cfgs()
    return jcfg, juv.init_params(jcfg, jax.random.key(1)), juv.init_params(jcfg, jax.random.key(2))


def _load_both(path, **kw):
    _, jp, _ = jinfer.load_ultravox_checkpoint(path, jnp.float32, **kw)
    _, tp, _ = tinfer.load_ultravox_checkpoint(path, torch.float32, device="cpu", **kw)
    return jp, tp


def test_full_checkpoint_wins_over_base_ids(tmp_path, trees):
    jcfg, trained, base = trees
    text_dir, audio_dir = _write_base_dirs(tmp_path, jcfg, base)
    jcfg_ids = _tiny_cfgs(text_model_id=text_dir, audio_model_id=audio_dir)[0]
    ckpt = jpub.save_pretrained(trained, jcfg_ids, str(tmp_path / "full_ckpt"))
    jp, tp = _load_both(ckpt)
    _compare(jp, tp)
    _compare(trained, tp)


def test_diff_checkpoint_uses_bases(tmp_path, trees):
    jcfg, trained, base = trees
    text_dir, audio_dir = _write_base_dirs(tmp_path, jcfg, base)
    jcfg_ids = _tiny_cfgs(text_model_id=text_dir, audio_model_id=audio_dir)[0]
    ckpt = jpub.save_pretrained(trained, jcfg_ids, str(tmp_path / "diff_ckpt"), diff_only=True)
    jp, tp = _load_both(ckpt)
    _compare(jp, tp)
    _compare(trained, tp, skip=("language_model", "audio_tower"))
    _compare(base, tp, skip=("projector",))


def test_diff_checkpoint_without_bases_fails_loudly(tmp_path, trees):
    jcfg, trained, _ = trees
    ckpt = jpub.save_pretrained(trained, jcfg, str(tmp_path / "orphan_diff"), diff_only=True)
    for loader, dt in ((jinfer.load_ultravox_checkpoint, jnp.float32),
                       (tinfer.load_ultravox_checkpoint, torch.float32)):
        kw = {"device": "cpu"} if loader is tinfer.load_ultravox_checkpoint else {}
        with pytest.raises(ValueError, match="random init"):
            loader(ckpt, dt, **kw)
    jp, tp = _load_both(ckpt, strict=False)
    _compare(jp, tp, skip=("language_model", "audio_tower"))  # the towers: random init


def _partial_sd(trained):
    return {
        "language_model.model.layers.1.self_attn.q_proj.weight":
            np.asarray(trained["language_model"]["layers"]["q_proj"]["kernel"][1]).T,
        "language_model.model.embed_tokens.weight":
            np.asarray(trained["language_model"]["embed_tokens"]),
        "audio_tower.layers.0.fc1.weight":
            np.asarray(trained["audio_tower"]["layers"]["fc1"]["kernel"][0]).T,
        "audio_tower.layers.0.fc1.bias":
            np.asarray(trained["audio_tower"]["layers"]["fc1"]["bias"][0]),
        "audio_tower.conv1.weight": np.asarray(trained["audio_tower"]["conv1"]["kernel"]).transpose(2, 1, 0),
        "language_model.lm_head.weight":
            np.asarray(trained["language_model"]["lm_head"]["kernel"]).T,
    }


def test_partial_overlay_merges_per_key(trees):
    """Per-key overlay onto a base tree equals JAX's; the base tree is not
    modified."""
    jcfg, trained, base = trees
    tcfg = _tiny_cfgs()[1]
    sd = _partial_sd(trained)
    want = jw.convert_ultravox(sd, jcfg, jnp.float32, base=jax.tree.map(lambda x: x, base))
    tbase = _to_port(base)
    before = {k: v.clone() for k, v in _flat(tbase).items()}
    got = tw.convert_ultravox({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                              tcfg, torch.float32, base=tbase)
    _compare(want, got)
    assert all(torch.equal(v, _flat(tbase)[k]) for k, v in before.items())


def test_partial_overlay_without_base_warns_and_skips(trees, caplog):
    import logging

    _, tcfg = _tiny_cfgs()
    sd = {"language_model.model.layers.0.self_attn.q_proj.weight": torch.zeros((48, 48))}
    with caplog.at_level(logging.WARNING):
        out = tw.convert_ultravox(sd, tcfg, torch.float32, base={})
    assert "language_model" not in out
    assert any("IGNORED" in rec.message for rec in caplog.records)


FAMILIES = {
    "gemma2": dict(model_type="gemma2", sliding_window=8, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, query_pre_attn_scalar=16),
    "gemma3": dict(model_type="gemma3_text", sliding_window=8, rope_local_base_freq=10000.0,
                   layer_types=["sliding_attention", "full_attention"]),
    "qwen2": dict(model_type="qwen2", tie_word_embeddings=True),
    "qwen3": dict(model_type="qwen3"),
    "llama_tied": dict(model_type="llama", tie_word_embeddings=True,
                       rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192}),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decoder_families_load_like_the_reference(tmp_path, family):
    """A full checkpoint of each decoder family, written by JAX's
    save_pretrained: both loaders give the same tree (q/k norms, gemma's
    pre/post FFN norms, qwen-2's q/k/v biases, no lm_head when tied), the
    port's config equals JAX's, and the port's save_pretrained writes the
    same config.json dict and tensors."""
    text = dict(vocab_size=384, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=12, **FAMILIES[family])
    d = {"audio_config": {"model_type": "whisper", "d_model": 32, "encoder_layers": 2,
                          "encoder_attention_heads": 2, "encoder_ffn_dim": 64},
         "text_config": text, "hidden_size": 64}
    jcfg, tcfg = jc.UltravoxConfig.from_hf_dict(d), tc.UltravoxConfig.from_hf_dict(d)
    assert jpub.config_to_hf_dict(jcfg) == tpub.config_to_hf_dict(tcfg)
    jparams = juv.init_params(jcfg, jax.random.key(3))
    ckpt = jpub.save_pretrained(jparams, jcfg, str(tmp_path / family))
    jp, tp = _load_both(ckpt)
    _compare(jp, tp)
    lm = tp["language_model"]
    assert ("lm_head" in lm) == (not tcfg.text_config.tie_word_embeddings)
    assert ("q_norm" in lm["layers"]) == tcfg.text_config.qk_norm
    assert ("pre_ffn_ln" in lm["layers"]) == tcfg.text_config.use_post_norms
    assert ("bias" in lm["layers"]["q_proj"]) == tcfg.text_config.attention_bias
    out = tpub.save_pretrained(tp, tcfg, str(tmp_path / f"{family}_port"))
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(jpub.config_to_hf_dict(jcfg)))
    mine, ref = tw.load_safetensors_dir(out), tw.load_safetensors_dir(ckpt)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        _same(mine[k], ref[k])


@pytest.mark.parametrize("family", [None] + list(FAMILIES))
def test_config_round_trips_through_config_json(family):
    """config_to_hf_dict then from_hf_dict gives the config back: the
    flagship widths (whisper-small + Llama-3.2-1B, as chip_smoke.py loads
    them) and each decoder family."""
    if family is None:
        cfg = tc.UltravoxConfig(
            audio_config=tc.WhisperEncoderConfig(d_model=768, num_layers=12, num_heads=12,
                                                 ffn_dim=3072),
            text_config=tc.DecoderConfig(vocab_size=128256, hidden_size=2048,
                                         intermediate_size=8192, num_layers=16, num_heads=32,
                                         num_kv_heads=8, head_dim=64, rope_theta=500000.0,
                                         tie_word_embeddings=True, max_position_embeddings=8192),
            hidden_size=3072, projector_ln_mid=True)
    else:
        cfg = tc.UltravoxConfig.from_hf_dict({"text_config": dict(FAMILIES[family])})
    assert tc.UltravoxConfig.from_hf_dict(json.loads(json.dumps(tpub.config_to_hf_dict(cfg)))) == cfg


@pytest.mark.parametrize("dtype,file_dtype,shards", [
    ("float32", "float32", 1), ("bfloat16", None, 1), ("bfloat16", None, 2),
    ("bfloat16", "float32", 3),
])
def test_save_pretrained_round_trips(tmp_path, dtype, file_dtype, shards):
    """save_pretrained then load_ultravox_checkpoint gives every leaf back
    bit for bit (fp32 or bf16 leaves, fp32 or the leaves' own dtype on
    disk, one file or shards with an index); JAX's loader reads the port's
    fp32 files equal; the reverse converters equal JAX's."""
    tdt = getattr(torch, dtype)
    cfg, params, _ = tinfer.load_ultravox_checkpoint(FIXTURE, tdt, device="cpu")
    fdt = None if file_dtype is None else getattr(torch, file_dtype)
    out = tpub.save_pretrained(params, cfg, str(tmp_path / "ckpt"), dtype=fdt, shards=shards)
    assert os.path.exists(os.path.join(out, tw.INDEX_FILE)) == (shards > 1)
    sd = tw.load_safetensors_dir(out)
    assert {v.dtype for v in sd.values()} == {fdt or tdt}
    _, back, _ = tinfer.load_ultravox_checkpoint(out, tdt, device="cpu")
    _compare(params, back)
    if file_dtype == "float32":
        jcfg, jp, _ = jinfer.load_ultravox_checkpoint(out, getattr(jnp, dtype))
        _compare(jp, back)
        jref = jw.convert_ultravox(jw.load_safetensors_dir(FIXTURE), jcfg, jnp.float32)
        want = {**jw.decoder_to_hf(jref["language_model"], jcfg.text_config),
                **jw.projector_to_hf(jref["projector"]), **jpub._encoder_to_hf(jref["audio_tower"], jcfg)}
        p32 = tinfer.load_ultravox_checkpoint(FIXTURE, torch.float32, device="cpu")[1]
        got = {**tw.decoder_to_hf(p32["language_model"], cfg.text_config),
               **tw.projector_to_hf(p32["projector"]), **tpub._encoder_to_hf(p32["audio_tower"], cfg)}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k].contiguous().numpy(), v), k


def test_save_pretrained_merges_lora(tmp_path):
    """LoRA adapters are folded into the kernels before writing, as the
    reference publishes; the written checkpoint has no adapter leaves."""
    cfg, params, _ = tinfer.load_ultravox_checkpoint(FIXTURE, torch.float32, device="cpu")
    lcfg = tc.LoraConfig(r=2, target_modules=("q_proj",))
    lm = tlora.add_lora(params["language_model"], lcfg, torch.Generator().manual_seed(0),
                        {"q_proj": "q_proj"})
    lm["layers"]["q_proj"]["lora_b"] = torch.full_like(lm["layers"]["q_proj"]["lora_b"], 0.01)
    tree = dict(params, language_model=lm)
    out = tpub.save_pretrained(tree, cfg, str(tmp_path / "lora"))
    _, back, _ = tinfer.load_ultravox_checkpoint(out, torch.float32, device="cpu")
    merged = tlora.merge_lora(tree)["language_model"]["layers"]["q_proj"]["kernel"]
    assert torch.equal(back["language_model"]["layers"]["q_proj"]["kernel"], merged)
    assert not torch.equal(merged, params["language_model"]["layers"]["q_proj"]["kernel"])
    assert not any("lora" in k for k in tw.load_safetensors_dir(out))


def test_unported_parts_raise_and_checkpoints_resolve(tmp_path, monkeypatch):
    """wav2vec2 towers and include_code raise NotImplementedError; a local
    directory resolves to itself, a missing one raises; hf:// and wandb://
    go to their (lazily imported) downloaders."""
    Wav2Vec2EncoderConfig = type("Wav2Vec2EncoderConfig", (), {})
    with pytest.raises(NotImplementedError, match="item 8"):
        tw.convert_audio_tower_checkpoint({}, Wav2Vec2EncoderConfig())
    cfg, params, _ = tinfer.load_ultravox_checkpoint(FIXTURE, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="include_code"):
        tpub.save_pretrained(params, cfg, str(tmp_path / "x"), include_code=True)
    assert tinfer.resolve_checkpoint(FIXTURE) == FIXTURE
    with pytest.raises(FileNotFoundError):
        tinfer.resolve_checkpoint(str(tmp_path / "missing"))
    fake_hub = types.ModuleType("huggingface_hub")
    fake_hub.snapshot_download = lambda repo: f"/hub/{repo}"
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake_hub)
    assert tinfer.resolve_checkpoint("hf://org/model") == "/hub/org/model"
    artifact = types.SimpleNamespace(download=lambda: "/wandb/dir")
    monkeypatch.setattr(wandb_utils, "get_artifact", lambda url: artifact)
    assert tinfer.resolve_checkpoint("wandb://e/p/a:v1") == "/wandb/dir"
    assert wandb_utils.is_wandb_url("wandb://x") and not wandb_utils.is_wandb_url("/x")
    sd = {"a": torch.ones(2, dtype=torch.bfloat16, requires_grad=False)}
    assert tw.from_torch_state_dict(sd)["a"].dtype == torch.float32


def test_load_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinfer.load_ultravox_checkpoint(FIXTURE)
