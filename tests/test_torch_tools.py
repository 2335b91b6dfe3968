"""The port's host tools against the JAX package's, on the CPU.

- ``tools/model_averaging.py``: ``average_state_dicts`` bit-equal to
  JAX's on the same numpy inputs (fp32, bf16, fp16 and int32 tensors; 2
  and 3 inputs), and ``average_checkpoints`` writing the same tensors and
  config from checkpoint directories and single files; the averaged tiny
  checkpoint loads through ``load_ultravox_checkpoint``;
- ``tools/projector_tools.py``: ``fit_embedding_map``,
  ``combine_projector`` (with and without the pre-v0.5 ``ln_post``) and
  ``upproject_adapter`` within 1e-6 of JAX's on the same numpy inputs, and
  the exact-linear case of the reference's test through the port's
  projector;
- ``tools/publish.py::save_pretrained(include_code=True)``: the same five
  code files, byte for byte, and the same ``config.json`` (``auto_map``
  included) as JAX's; the directory loads through its own code files with
  ``transformers`` to logits within 1e-4 of the port's ``ultravox_forward``
  in fp32.
"""

import json
import os
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from tests.helpers import make_tiny_tokenizer
from tests.test_hub_code import _load_standalone
from ultravox_torch.inference.ultravox_infer import load_ultravox_checkpoint
from ultravox_torch.models import config as tc
from ultravox_torch.models import projector as tprojector
from ultravox_torch.models import ultravox as tuv
from ultravox_torch.models.weights import load_safetensors_dir
from ultravox_torch.tools import model_averaging as tavg
from ultravox_torch.tools import projector_tools as tproj
from ultravox_torch.tools import publish as tpub
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.tools import model_averaging as javg
from ultravox_tpu.tools import projector_tools as jproj
from ultravox_tpu.tools import publish as jpub

FIXTURE = "tests/assets/tiny_ultravox"
HUB_FILES = ("ultravox_config.py", "ultravox_model.py", "ultravox_processing.py",
             "ultravox_tokenizer.py", "ultravox_pipeline.py")


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)  # np.mean of a 0-d array gives a numpy scalar
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _numpy_bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _state_dicts(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "f32": rng.standard_normal((7, 5)).astype(np.float32),
            "bf16": rng.standard_normal((3, 11)).astype(ml_dtypes.bfloat16),
            "f16": rng.standard_normal((13,)).astype(np.float16),
            "i32": rng.integers(-50, 50, (4, 4)).astype(np.int32),
            "scalar": np.asarray(rng.standard_normal(), np.float32),
        })
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_average_state_dicts_bit_equal_to_jax(n):
    dicts = _state_dicts(n)
    want = javg.average_state_dicts(dicts)
    got = tavg.average_state_dicts([{k: _torch(v) for k, v in d.items()} for d in dicts])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == _torch(w).dtype, k
        np.testing.assert_array_equal(_numpy_bits(got[k]), _numpy_bits(_torch(w)), err_msg=k)


def test_average_state_dicts_refuses_what_jax_refuses():
    a = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="disagree"):
        tavg.average_state_dicts([a, {"v": torch.ones(2)}])
    with pytest.raises(ValueError, match="nothing"):
        tavg.average_state_dicts([])


def _perturbed_checkpoints(base, n: int):
    """n copies of the tiny checkpoint, each tensor moved by seeded noise:
    two directories and, for the last, a single safetensors file."""
    sd = safetensors.numpy.load_file(os.path.join(FIXTURE, "model.safetensors"))
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n):
        moved = {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(v.dtype)
                 for k, v in sd.items()}
        if i < n - 1:
            d = base / f"in{i}"
            d.mkdir()
            shutil.copy(os.path.join(FIXTURE, "config.json"), d / "config.json")
            safetensors.numpy.save_file(moved, str(d / "model.safetensors"))
            paths.append(str(d))
        else:
            safetensors.numpy.save_file(moved, str(base / "last.safetensors"))
            paths.append(str(base / "last.safetensors"))
    return paths


def test_average_checkpoints_bit_equal_to_jax(tmp_path):
    inputs = _perturbed_checkpoints(tmp_path, 3)
    tout = tavg.average_checkpoints(inputs, str(tmp_path / "port"))
    jout = javg.average_checkpoints(inputs, str(tmp_path / "jax"))
    got = load_safetensors_dir(tout)
    want = safetensors.numpy.load_file(os.path.join(jout, "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    with open(os.path.join(tout, "config.json")) as f, \
            open(os.path.join(jout, "config.json")) as g:
        assert json.load(f) == json.load(g)
    cfg, params, _ = load_ultravox_checkpoint(tout, torch.float32, device="cpu")
    assert cfg.text_config.vocab_size == 384
    want_embed = want["language_model.model.embed_tokens.weight"]
    np.testing.assert_array_equal(params["language_model"]["embed_tokens"].numpy(), want_embed)


def test_model_averaging_cli(tmp_path, capsys):
    inputs = _perturbed_checkpoints(tmp_path, 2)
    tavg.main(["--inputs", *inputs, "--output", str(tmp_path / "out")])
    assert capsys.readouterr().out.strip() == str(tmp_path / "out")
    assert os.path.exists(tmp_path / "out" / "model.safetensors")


def _projector_inputs(ln_post: bool):
    rng = np.random.default_rng(1)
    d_small, d_big, V, mid = 16, 24, 200, 32
    proj = {"linear_1": {"kernel": rng.standard_normal((64, 2 * mid)).astype(np.float32)},
            "linear_2": {"kernel": rng.standard_normal((mid, d_small)).astype(np.float32)},
            "ln_pre": rng.standard_normal(64).astype(np.float32)}
    if ln_post:
        proj["ln_post"] = (1.0 + 0.1 * rng.standard_normal(d_small)).astype(np.float32)
    emb_small = rng.standard_normal((V, d_small)).astype(np.float32)
    emb_big = (emb_small @ rng.standard_normal((d_small, d_big)) * 0.3
               + 0.01 * rng.standard_normal((V, d_big))).astype(np.float32)
    return proj, emb_small, emb_big


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("ln_post", [False, True])
def test_projector_tools_match_jax(ln_post):
    proj, emb_small, emb_big = _projector_inputs(ln_post)
    for ridge in (1e-4, 1e-8):
        want = jproj.fit_embedding_map(emb_small, emb_big, ridge)
        got = tproj.fit_embedding_map(torch.from_numpy(emb_small), torch.from_numpy(emb_big),
                                      ridge)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    M = jproj.fit_embedding_map(emb_small, emb_big)
    for got, want in ((tproj.combine_projector(_as_torch(proj), torch.from_numpy(M)),
                       jproj.combine_projector(proj, M)),
                      (tproj.upproject_adapter(_as_torch(proj), torch.from_numpy(emb_small),
                                               torch.from_numpy(emb_big)),
                       jproj.upproject_adapter(proj, emb_small, emb_big))):
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(got["linear_2"]["kernel"].numpy(),
                                   np.asarray(want["linear_2"]["kernel"]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["linear_1"]["kernel"].numpy(),
                                      proj["linear_1"]["kernel"])
        if ln_post:
            np.testing.assert_allclose(got["ln_post"].numpy(), np.asarray(want["ln_post"]),
                                       rtol=0, atol=1e-6)


def test_combined_projector_reproduces_the_map():
    """The reference's exact-linear case through the port's projector: the
    combined projector's output equals the small one's times the map."""
    rng = np.random.default_rng(0)
    d_small, d_big, V = 16, 24, 200
    M_true = rng.standard_normal((d_small, d_big)).astype(np.float32) * 0.3
    emb_small = rng.standard_normal((V, d_small)).astype(np.float32)
    M = tproj.fit_embedding_map(torch.from_numpy(emb_small),
                                torch.from_numpy(emb_small @ M_true), ridge=1e-8)
    np.testing.assert_allclose(M.numpy(), M_true, atol=1e-4)

    def cfg(d):
        return tc.UltravoxConfig(audio_config=tc.WhisperEncoderConfig(d_model=8),
                                 text_config=tc.DecoderConfig(hidden_size=d), hidden_size=32,
                                 projector_ln_mid=True)

    proj = tprojector.init_params(cfg(d_small), torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((1, 16, 8)).astype(np.float32))
    small = tprojector.projector_forward(proj, cfg(d_small), x)
    big = tprojector.projector_forward(tproj.combine_projector(proj, M), cfg(d_big), x)
    np.testing.assert_allclose(big.detach().numpy(), (small @ M).detach().numpy(), atol=1e-4)


# -- publishing with the hub code ---------------------------------------------


def _hub_config(c):
    return c.UltravoxConfig(
        audio_config=c.WhisperEncoderConfig(d_model=64, num_layers=2, num_heads=4, ffn_dim=128,
                                            max_source_positions=1500),
        text_config=c.DecoderConfig(vocab_size=384, hidden_size=48, intermediate_size=96,
                                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=12,
                                    rope_theta=10000.0, max_position_embeddings=512),
        hidden_size=64, stack_factor=8, projector_ln_mid=True)


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """(port's cfg, params, dir, JAX's dir): the same config published with
    the hub code by each package (the port's weights are its own draws)."""
    base = tmp_path_factory.mktemp("hub")
    tcfg = _hub_config(tc)
    params = tuv.init_params(tcfg, torch.Generator().manual_seed(7))
    tpub.save_pretrained(params, tcfg, str(base / "port"), tokenizer=make_tiny_tokenizer(),
                         include_code=True)
    jcfg = _hub_config(jc)
    jpub.save_pretrained(juv.init_params(jcfg, jax.random.key(7)), jcfg, str(base / "jax"),
                         tokenizer=make_tiny_tokenizer(), include_code=True)
    return tcfg, params, str(base / "port"), str(base / "jax")


def test_published_code_and_config_match_jax(published):
    _, _, port, jax_dir = published
    for fname in HUB_FILES:
        with open(os.path.join(port, fname), "rb") as f, \
                open(os.path.join(jax_dir, fname), "rb") as g:
            assert f.read() == g.read(), fname
    with open(os.path.join(port, "config.json")) as f, \
            open(os.path.join(jax_dir, "config.json")) as g:
        got, want = json.load(f), json.load(g)
    assert got["auto_map"] == want["auto_map"]
    assert got["auto_map"]["AutoModel"] == "ultravox_model.UltravoxModel"
    assert got == want


def test_published_checkpoint_loads_through_its_code(published):
    """The directory's own code files (as transformers' remote code loads
    them) build a torch model from its config and safetensors whose
    logits are the port's ``ultravox_forward`` within 1e-4."""
    cfg, params, out, _ = published
    mods = _load_standalone(out)
    with open(os.path.join(out, "config.json")) as f:
        hf_cfg = mods["ultravox_config"][1].UltravoxConfig(**{
            k: v for k, v in json.load(f).items() if k not in ("auto_map", "model_type")})
    model = mods["ultravox_model"][1].UltravoxModel(hf_cfg)
    sd = safetensors.torch.load_file(os.path.join(out, "model.safetensors"))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert not [m for m in missing if "rotary" not in m and "position_ids" not in m], missing
    model.eval()

    rng = np.random.default_rng(0)
    T, frames, start = 48, 400, 5
    n_tok = -(-frames // 16)
    ids = torch.from_numpy(rng.integers(0, 300, size=(1, T)))
    mel = torch.from_numpy(rng.standard_normal((1, 80, frames)).astype(np.float32) * 0.3)
    audio = dict(audio_values=mel, audio_lens=torch.tensor([frames]),
                 audio_token_start_idx=torch.tensor([start]),
                 audio_token_len=torch.tensor([n_tok]), audio_chunk_batch_idx=torch.tensor([0]))
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=torch.ones(1, T, dtype=torch.long),
                     **audio).logits.float().numpy()
        batch = dict({k: v.to(torch.int32) if k != "audio_values" else v
                      for k, v in audio.items()}, input_ids=ids.to(torch.int32),
                     attention_mask=torch.ones(1, T, dtype=torch.int32))
        got = tuv.ultravox_forward(params, cfg, batch).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
