"""The port's tensor axis over several processes (gloo, on the CPU) against
the JAX package on its 8-device CPU mesh, fp32.

The tiny speech model of tests/test_torch_parallel_train.py (whisper 2 x
64 of 2 heads, llama 2 x 64 of 4 heads over 2 KV heads, an untied head,
projector 128, audio LoRA r 4 on q/v), KL loss, remat, the vocabulary in
chunks of 16, the projector and the audio LoRA factors trained. Each
world's ranks are spawned once (``tests/torch_dist_worker.py``, a module
fixture a world). Held:

- world 2 (tensor 2) and world 4 (fsdp 2 x tensor 2): one train step and
  one accumulated update (grad accum 2) against JAX's step on the same
  ``MeshConfig``: loss, grad norm and param norm within rtol 1e-5, updated
  trainables within 1e-5 (as the fsdp tests hold them);
- each rank holds 1/tensor (x 1/fsdp) of the bytes of every leaf JAX
  splits over ``tensor``, cut on the same dim;
- a config with one KV head at tensor 2 (each rank keeps the whole K/V
  projections and reads the one head) matches JAX's step;
- a planted fault (the all-reduce after ``o_proj`` dropped) fails the
  check;
- checkpoints: saved at tensor 2 and resumed at world 1, and the other
  way round, the next step equals an uninterrupted world-1 run (metrics
  within rtol 1e-5; trainables within 1e-5 but for 1 in 10^4 elements,
  which Adam moves by up to 1e-4 where a gradient is near its eps);
- ``python -m ultravox_torch.training.train`` with ``mesh_tensor 2`` over
  two processes logs what one process logs, writes the same checkpoint,
  and a world-1 run resumes from it;
- ``ServingEngine(mesh=)`` at tensor 2 in slots and paged mode, with
  speculative decoding, and with multi-LoRA (LM adapters, and encoder
  adapters on the fused encoder), and ``UltravoxInference(mesh=)`` on
  ``tests/assets/tiny_ultravox``: the greedy tokens of JAX's unsharded
  offline engine, equal on both ranks;
- ``quantize="int8"`` together with ``mesh=`` raises in every engine.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.helpers import make_tiny_tokenizer
from tests.test_torch_lora_serving import _batch as lora_batch
from tests.test_torch_lora_serving import _lora_tower
from tests.test_torch_parallel_train import (
    CHUNK,
    LR,
    OPT,
    PARAM_ATOL,
    TRAINABLE,
    _loss_configs,
    assert_metrics,
    assert_trainables,
    concat,
    configs,
    jax_params,
    local_batch,
    port_run,
    world2_batches,
)
from tests.test_torch_train_loop import LOSS_ATOL, LOSS_RTOL, NORM_RTOL, PORT_YAML, _argv, read_log
from tests.torch_dist_worker import start
from tests.torch_parity import make_configs, make_params, synth_audio
from ultravox_torch.inference.engine import GenerationEngine
from ultravox_torch.inference.serving.engine import ServingEngine
from ultravox_torch.parallel import mesh as tmesh
from ultravox_torch.training import config as ttcfg
from ultravox_torch.training import train as ttrain
from ultravox_tpu.data.sample import VoiceSample as JVoiceSample
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.inference.ultravox_infer import UltravoxInference as JUltravoxInference
from ultravox_tpu.models.lora import DECODER_TARGETS, ENCODER_TARGETS
from ultravox_tpu.parallel import mesh as jmesh
from ultravox_tpu.parallel import multihost as jmh
from ultravox_tpu.parallel import sharding as jsh
from ultravox_tpu.training import train_step as jts

MAX_NEW = 8
FIXTURE = "tests/assets/tiny_ultravox"


def tensor2_batches(step):
    """One batch shard: 2 rows of 32 tokens, 3 chunks (two in row 0)."""
    return [local_batch(10 * step + 5, 2, 32, 20, [0, 0, 1], [160, 96, 144])]


def kv1_configs():
    """configs() with one KV head."""
    import dataclasses

    return tuple(dataclasses.replace(c, text_config=dataclasses.replace(
        c.text_config, num_kv_heads=1)) for c in configs())


# name: (configs, batches, data, fsdp, tensor)
WORLDS = {"world2-tensor2": (configs, tensor2_batches, 1, 1, 2),
          "world4-fsdp2xtensor2": (configs, world2_batches, 1, 2, 2),
          "world2-tensor2-kv1": (kv1_configs, tensor2_batches, 1, 1, 2)}


def _jax_mesh(data, fsdp, tensor):
    return jmesh.make_mesh(jmesh.MeshConfig(data=data, fsdp=fsdp, tensor=tensor, pipe=1),
                           jax.devices()[: data * fsdp * tensor])


@functools.lru_cache(maxsize=None)
def jax_run(world, steps, accum=1):
    """JAX's steps on the world's mesh, on the global batches of its first
    ``steps`` steps: (metrics, trainables, the clipped gradient's
    magnitude read off Adam's first update), as test_torch_parallel_train
    computes them."""
    mk, batches, data, fsdp, tensor = WORLDS[world]
    jcfg, _ = mk()
    jp = jax_params(jcfg)
    mesh = _jax_mesh(data, fsdp, tensor)
    opt = jts.make_optimizer(LR, **OPT)
    if accum > 1:
        opt = optax.MultiSteps(opt, accum)
    state, template = jts.init_train_state(jsh.shard_params(jp, mesh), opt, TRAINABLE)
    p0 = {k: np.asarray(v) for k, v in state.trainable.items()}
    step = jax.jit(jts.make_train_step(jcfg, _loss_configs()[0], opt, template, remat=False,
                                       attn_impl="xla", vocab_chunk=CHUNK))
    metrics = []
    for s in range(steps):
        state, m = step(state, jmh.make_global_batch(concat(batches(s)), mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    p1 = {k: np.asarray(v) for k, v in state.trainable.items()}
    eps = 1e-8
    ratio = {k: np.clip(np.abs((p0[k] - p1[k]) / LR - OPT["weight_decay"] * p0[k]), 0, 1 - 1e-7)
             for k in p0}
    return metrics, p1, {k: eps * r / (1 - r) for k, r in ratio.items()}


def _step_spec(world, runs):
    mk, _, data, fsdp, tensor = WORLDS[world]
    jcfg, tcfg = mk()
    return dict(params=jax.tree.map(np.asarray, jax_params(jcfg)), cfg=tcfg, data=data, fsdp=fsdp,
                tensor=tensor, lr=LR, opt=OPT, trainable=TRAINABLE,
                loss_config=_loss_configs()[1], vocab_chunk=CHUNK, runs=runs)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """Three uninterrupted world-1 steps on the tensor-2 batches,
    checkpoint-2 saved on the way."""
    _, tcfg = configs()
    npp = jax.tree.map(np.asarray, jax_params(configs()[0]))
    d = str(tmp_path_factory.mktemp("world1"))
    metrics, state = port_run(tcfg, npp, [concat(tensor2_batches(s)) for s in range(3)],
                              save_at=(d, 2))
    return d, metrics, {k: v.detach().clone() for k, v in state.trainable.items()}, npp


@pytest.fixture(scope="module")
def world2(world1, tmp_path_factory):
    """One gloo group of 2 ranks (tensor 2): a step, an accumulated update,
    the planted fault, 2 steps saved, and a resume of world 1's checkpoint."""
    d = str(tmp_path_factory.mktemp("tensor2"))
    save = os.path.join(d, "saved")
    b = tensor2_batches
    runs = [
        {"batches": [b(0)]},
        {"batches": [b(0), b(1)], "accum": 2},
        {"batches": [b(0)], "fault": "no_o_proj_reduce"},
        {"batches": [b(0), b(1)], "save": save},
        {"batches": [b(2)], "resume": os.path.join(world1[0], "checkpoint-2")},
    ]
    return start("step", _step_spec("world2-tensor2", runs), os.path.join(d, "run"),
                 world=2), save


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fsdp2xtensor2"))
    runs = [{"batches": [world2_batches(0)]},
            {"batches": [world2_batches(0), world2_batches(1)], "accum": 2}]
    return start("step", _step_spec("world4-fsdp2xtensor2", runs), d, world=4)


@pytest.fixture(scope="module")
def world2_kv1(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("kv1"))
    return start("step", _step_spec("world2-tensor2-kv1", [{"batches": [tensor2_batches(0)]}]),
                 d, world=2)


def _ranks(request, world):
    name = {"world2-tensor2": "world2", "world4-fsdp2xtensor2": "world4",
            "world2-tensor2-kv1": "world2_kv1"}[world]
    out = request.getfixturevalue(name)
    return out[0] if name == "world2" else out


@pytest.mark.parametrize("world", ["world2-tensor2", "world4-fsdp2xtensor2"])
def test_tensor_step_and_accumulated_update_match_jax(request, world):
    _, _, data, fsdp, tensor = WORLDS[world]
    ranks = _ranks(request, world)
    want = [jax_run(world, 1, 1), jax_run(world, 2, 2)]  # while the ranks run
    out = ranks.result()
    assert out["mesh"] == {"data": data, "fsdp": fsdp, "tensor": tensor, "pipe": 1}
    for run, (jm, jtr, grad) in zip(out["runs"][:2], want):
        assert jm[0]["grad_norm"] > OPT["max_grad_norm"]  # clipping ran
        assert_metrics(run["metrics"], jm)
        assert_trainables(run["trainable"], jtr, grad)


@pytest.mark.parametrize("world", ["world2-tensor2", "world4-fsdp2xtensor2"])
def test_each_rank_holds_its_tensor_slice(request, world):
    mk, _, data, fsdp, tensor = WORLDS[world]
    jcfg, _ = mk()
    jp = jax_params(jcfg)
    out = _ranks(request, world).result()
    specs = dict(_path_items(jax.tree.map(
        tuple, jsh.param_pspecs(jp, jsh.DEFAULT_RULES, _jax_mesh(data, fsdp, tensor)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    for rank, facts in enumerate(out["per_rank"]):
        split = []
        for path, (storage, nbytes, full, _) in facts["held"][0].items():
            spec, dim = specs[path], facts["split"][0][path]
            full_bytes = int(np.prod(full)) * 4
            parts = (tensor if "tensor" in spec else 1) * (fsdp if "fsdp" in spec else 1)
            assert storage == nbytes == full_bytes // parts, (rank, path)
            if "tensor" in spec:
                split.append(path)
                assert dim == spec.index("tensor") - len(full), (rank, path)
            else:
                assert dim is None, (rank, path)
        for path in ("language_model/layers/q_proj/kernel", "language_model/layers/o_proj/kernel",
                     "language_model/layers/down_proj/kernel", "language_model/embed_tokens",
                     "language_model/lm_head/kernel", "audio_tower/layers/fc1/bias",
                     "audio_tower/layers/out_proj/kernel"):
            assert path in split, path


def _path_items(tree, prefix=""):
    from ultravox_torch.training.train_step import _path_items as items

    return items(tree, prefix)


def test_one_kv_head_at_tensor2_matches_jax(world2_kv1):
    """Each rank keeps the whole K/V projections and reads the one head."""
    want, _, _ = jax_run("world2-tensor2-kv1", 1, 1)
    out = world2_kv1.result()
    assert_metrics(out["runs"][0]["metrics"], want)
    kept = out["per_rank"][1]["held"][0]["language_model/layers/k_proj/kernel"]
    assert kept[0] == kept[1] == int(np.prod(kept[2])) * 4  # whole on every rank


def test_dropped_o_proj_reduce_fails_the_check(world2):
    out = world2[0].result()
    jm, _, _ = jax_run("world2-tensor2", 1, 1)
    with pytest.raises(AssertionError):
        assert_metrics(out["runs"][2]["metrics"], jm)
    assert_metrics(out["runs"][0]["metrics"], jm)


def test_resume_tensor2_checkpoint_at_world1(world1, world2):
    """Two steps at tensor 2, saved; the third at world 1 from that
    checkpoint equals the uninterrupted world-1 run's third step."""
    _, tcfg = configs()
    _, w1_metrics, w1_trainable, npp = world1
    out, save = world2[0].result(), world2[1]
    assert out["runs"][3]["step"] == 2
    metrics, state = port_run(tcfg, npp, [concat(tensor2_batches(2))],
                              resume=os.path.join(save, "checkpoint-2"))
    assert state.step == 3
    assert_metrics(metrics, w1_metrics[2:])
    for k, v in state.trainable.items():
        # two tensor-2 steps sum in another order than world 1's; Adam
        # amplifies that where a gradient is near its eps (2 of 65536
        # elements of linear_1 moved by 1.24e-5), so 1e-5 holds for all but
        # 1 in 10^4 elements and 1e-4 for every one
        got, want = v.detach().numpy(), w1_trainable[k].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=k)
        assert (np.abs(got - want) <= PARAM_ATOL).mean() >= 0.9999, k


def test_resume_world1_checkpoint_at_tensor2(world1, world2):
    _, w1_metrics, w1_trainable, _ = world1
    run = world2[0].result()["runs"][4]
    assert run["step"] == 3
    assert_metrics(run["metrics"], w1_metrics[2:])
    for k, v in run["trainable"].items():
        np.testing.assert_allclose(v.numpy(), w1_trainable[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


# -- the training CLI -----------------------------------------------------------


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """train() on tests' test_train.yaml at tensor 2 over two processes and
    at world 1 in this process (the same seed, data and weights), then a
    world-1 run resumed from the tensor-2 output for one more step."""
    base = tmp_path_factory.mktemp("cli")
    tok = str(base / "tok")
    make_tiny_tokenizer().save_pretrained(tok)
    over = {"report_logs_to": []}
    argv2 = _argv(PORT_YAML, base / "tensor2", tok, dict(over, mesh_tensor=2)) + [
        "--device", "cpu"]
    ranks = start("train", dict(argv=argv2), str(base / "run"), world=2)
    ttrain.train(ttcfg.get_train_config(_argv(PORT_YAML, base / "one", tok, over)
                                        + ["--device", "cpu"]))
    ranks.result()
    ttrain.train(ttcfg.get_train_config(_argv(PORT_YAML, base / "resumed", tok, dict(
        over, max_steps=3, model_load_dir=str(base / "tensor2"), resume_from_load_dir=True))
        + ["--device", "cpu"]))
    return base


def test_train_cli_at_tensor2_matches_world1_and_resumes(cli):
    one, two = read_log(cli / "one"), read_log(cli / "tensor2")
    assert [r["step"] for r in two] == [r["step"] for r in one] == [1, 2]
    for a, b in zip(one, two):
        for k in a:
            if k in ("step", "samples_per_s"):
                continue
            loss = "loss" in k
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL if loss else NORM_RTOL,
                                       atol=LOSS_ATOL if loss else 0.0, err_msg=f"{a['step']} {k}")
    s1 = torch.load(cli / "one" / "checkpoint-2" / "state.pt", weights_only=True)
    s2 = torch.load(cli / "tensor2" / "checkpoint-2" / "state.pt", weights_only=True)
    assert s1["step"] == s2["step"] == 2
    for k, v in s1["trainable"].items():
        assert s2["trainable"][k].shape == v.shape
        torch.testing.assert_close(s2["trainable"][k], v, rtol=0, atol=1e-5, msg=k)
    with open(cli / "tensor2" / "train_config.json") as f:
        assert json.load(f)["mesh_tensor"] == 2
    resumed = read_log(cli / "resumed")
    assert [r["step"] for r in resumed] == [3] and np.isfinite(resumed[0]["loss"])


# -- serving ------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """One gloo group of 2 ranks (tensor 2) serving the tiny speech model of
    tests/torch_parity.py five ways, then UltravoxInference(mesh=) on the
    tiny checkpoint; with JAX's unsharded greedy tokens for each."""
    jcfg, tcfg = make_configs()
    jp, _ = make_params(jcfg, tcfg)
    rng = np.random.default_rng(1)
    comp = jcfg.audio_token_compression
    text = [lora_batch(rng, 20), lora_batch(rng, 33), lora_batch(rng, 11)]
    audio = lora_batch(rng, 24, 1.5, comp)
    rep = rng.integers(1, 512, 5)  # a repeating prompt, so drafts hit
    ids = np.tile(rep, 8)[None].astype(np.int32)
    spec_batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    lm = {n: {"language_model": _lora_tower(jp["language_model"], ("q_proj", "v_proj",
                                                                    "o_proj", "down_proj"),
                                            4, 10 + i, 0.5, DECODER_TARGETS)}
          for i, n in enumerate(("a", "b"))}
    enc = {"x": {"audio_tower": _lora_tower(jp["audio_tower"], ("q_proj", "v_proj", "out_proj",
                                                                "fc1"), 2, 30, 0.1,
                                            ENCODER_TARGETS)}}
    base = dict(num_slots=4, max_seq_len=128, prefill_len_buckets=(64, 128),
                mel_len_buckets=(400,), prefill_chunk_tokens=16)
    runs = [
        ("slots", dict(base, cache_mode="slots", decode_block_steps=4),
         [text[0], audio, text[1]], [None] * 3, {}),
        ("paged", dict(base, cache_mode="paged", page_size=16, decode_block_steps=4),
         [text[0], audio, text[1]], [None] * 3, {}),
        ("spec", dict(base, cache_mode="paged", page_size=16, decode_block_steps=2,
                      spec_decode="ngram", spec_k=4, spec_min_accept=0),
         [spec_batch, text[2]], [None] * 2, {}),
        ("lora", dict(base, cache_mode="slots", decode_block_steps=4),
         [text[0], text[0], text[0], text[2]], [None, "a", "b", "b"], lm),
        ("enc_lora", dict(base, cache_mode="paged", page_size=16, encoder_attn_impl="fused"),
         [audio, audio], [None, "x"], enc),
    ]
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    for name in ("config.json", "model.safetensors"):
        shutil.copy(f"{FIXTURE}/{name}", os.path.join(ckpt, name))
    make_tiny_tokenizer().save_pretrained(ckpt)
    samples = [("hello world how are you", None),
               ("transcribe <|audio|> please", synth_audio(1.0, 1))]
    d = str(tmp_path_factory.mktemp("serve"))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    spec = dict(params=np_tree(jp), cfg=tcfg, tensor=2, max_tokens=MAX_NEW, ckpt=ckpt,
                infer=samples,
                runs=[{"kw": kw, "batches": b, "names": n, "max_tokens": MAX_NEW,
                       "adapters": {k: np_tree(v) for k, v in ad.items()}}
                      for _, kw, b, n, ad in runs])
    ranks = start("serve", spec, d, world=2, timeout=400)
    expected = {}
    for name, kw, batches, names, ad in runs:
        engines = {}
        exp = []
        for batch, n in zip(batches, names):
            if n not in engines:
                p = dict(jp)
                if n is not None:
                    p.update(ad[n])
                engines[n] = JEngine(p, jcfg, max_cache_len=128, cache_dtype=jnp.float32,
                                     encoder_attn_impl=kw.get("encoder_attn_impl", "xla"))
            exp.append(engines[n].generate(batch, max_new_tokens=MAX_NEW).token_ids[0])
        expected[name] = exp
    jinf = JUltravoxInference(ckpt, dtype=jnp.float32, max_cache_len=256)
    want_infer = []
    for text_, audio_ in samples:
        js = (JVoiceSample.from_prompt(text_) if audio_ is None
              else JVoiceSample.from_prompt_and_audio(text_, audio_, 16000))
        o = jinf.infer(js, max_tokens=MAX_NEW)
        want_infer.append((o.text, o.input_tokens, o.output_tokens))
    return ranks, [r[0] for r in runs], expected, want_infer


@pytest.mark.parametrize("mode", ["slots", "paged", "spec", "lora", "enc_lora"])
def test_serving_engine_mesh_matches_jax_on_both_ranks(serving, mode):
    ranks, names, expected, _ = serving
    out = ranks.result()
    i = names.index(mode)
    want = [(e, "length") for e in expected[mode]]
    for rank, facts in enumerate(out["per_rank"]):
        assert facts["runs"][i]["tokens"] == want, (rank, mode)
    if mode == "spec":
        assert out["runs"][i]["spec_dispatches"] > 0
    if mode in ("slots", "paged", "lora"):
        assert out["runs"][i]["blocks"]  # K-step blocks ran
    if mode == "lora":
        assert len({tuple(e) for e in expected[mode][:3]}) == 3, "adapters must change tokens"
    if mode == "enc_lora":
        assert expected[mode][0] != expected[mode][1], "the encoder adapter must change tokens"


def test_ultravox_inference_mesh_matches_jax_on_both_ranks(serving):
    ranks, _, _, want = serving
    out = ranks.result()
    for facts in out["per_rank"]:
        assert facts["infer"] == want
    assert all(t for t, _, _ in want)


def test_quantize_with_mesh_raises():
    _, tcfg = make_configs()
    mesh = tmesh.Mesh.local(tmesh.MeshConfig(1, 1, 2, 1), 2)
    with pytest.raises(ValueError, match="quantize= is not supported together with mesh="):
        ServingEngine({}, tcfg, mesh=mesh, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="quantize= is not supported together with mesh="):
        GenerationEngine({}, tcfg, mesh=mesh, quantize="int8", device="cpu")
