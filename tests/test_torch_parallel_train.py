"""The port's train step over several processes (gloo, on the CPU) against
the JAX package's step on the same mesh shape.

A tiny speech model (whisper 2 x 64, llama 2 x 64 with an untied head,
projector 128, audio LoRA r 4) from JAX's init, fp32, KL loss, remat, the
vocabulary in chunks of 16; the projector and the audio LoRA factors are
trained. The port runs its ranks in spawned processes
(``tests/torch_dist_worker.py``, one gloo group per module fixture); JAX
runs in this process on ``make_mesh`` + ``shard_params`` +
``make_global_batch`` over the 8 CPU devices of ``tests/conftest.py``, on
the global batch: the ranks' local batches padded to one shape, their
audio chunks' row index made global. The ranks' batches are ragged: they
differ in text length, teacher length, audio chunk count and supervised
positions.

Held (fp32; each tolerance stated where it is used):

- world 2 (fsdp 2) and world 4 (data 2 x fsdp 2): one train step and one
  accumulated update (grad accum 2): loss, grad norm and param norm
  within rtol 1e-5, updated trainables within 1e-5 absolute where the
  clipped JAX gradient exceeds 1e-7 (as tests/test_torch_train.py holds
  one process); each rank holds exactly 1/fsdp of the bytes of every
  leaf JAX shards over fsdp, and all of every other;
- a planted fault, each rank's mean averaged over the ranks in place of
  the global sum over the global count, fails that check;
- ranks that differ in carrying audio (fsdp 2, rank 0 with audio, rank 1
  text-only): the step equals JAX's on the global batch (the text-only
  rank runs the tower's gathers on a dummy chunk that adds zero);
- checkpoints: saved at world 2 and resumed at world 1, and the other way
  round, the next step equals an uninterrupted world-1 run; the master's
  export at world 2 is byte-equal to one process's export of the same
  state.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_dist_worker import start
from ultravox_torch.models import config as tc
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.parallel import sharding as tsh
from ultravox_torch.training import checkpoint as tckpt
from ultravox_torch.training import train_step as tts
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import lora as jlora
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.parallel import mesh as jmesh
from ultravox_tpu.parallel import multihost as jmh
from ultravox_tpu.parallel import sharding as jsh
from ultravox_tpu.training import train_step as jts

TRAINABLE = (r".*projector/.*", r".*audio_tower/.*lora_[ab]$")
LR = 1e-3
OPT = dict(warmup_steps=0, total_steps=10, weight_decay=0.01, max_grad_norm=0.05)
CHUNK = 16
T_MEL = 160
METRIC_RTOL, PARAM_ATOL, GRAD_FLOOR = 1e-5, 1e-5, 1e-7
TEXT_KEYS = ("input_ids", "attention_mask", "labels", "alt_input_ids", "alt_attention_mask",
             "alt_labels")
CHUNK_KEYS = ("audio_values", "audio_lens", "audio_token_len", "audio_token_start_idx",
              "audio_chunk_batch_idx")


def configs():
    def mk(c):
        return c.UltravoxConfig(
            audio_config=c.WhisperEncoderConfig(d_model=64, num_layers=2, num_heads=2,
                                                ffn_dim=128, max_source_positions=1500),
            text_config=c.DecoderConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                                        tie_word_embeddings=False),
            hidden_size=128, projector_ln_mid=True)

    return mk(jc), mk(tc)


def jax_params(jcfg):
    """JAX's init with the matrices scaled up and rank-4 audio LoRA on q/v
    with lora_b away from zero. The language model is scaled 4x, not the 8x
    of tests/torch_parity.py: at 8x the KL gradient of some of these random
    batches is ill-conditioned in fp32 (the port, JAX and a float64
    evaluation of the port differ by up to 0.2% in its norm, each side's
    fp32 against fp64), which no fp32 comparison can hold to 1e-5."""
    params = juv.init_params(jcfg, jax.random.key(0))
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 4.0}
    params = {k: jax.tree.map(lambda a, f=scale[k]: a * f if a.ndim >= 2 else a, v)
              for k, v in params.items()}
    params = jlora.apply_lora_to_model(params, jc.LoraConfig(), jc.LoraConfig(
        r=4, target_modules=("q_proj", "v_proj")), jax.random.key(3))
    rng = np.random.default_rng(9)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype)
        if str(p[-1].key) == "lora_b" else a, params)


def local_batch(seed, rows, T, T2, chunk_rows, lens, vocab=256, compression=16):
    """One rank's collated KL batch: chunk i of audio (T_MEL mel frames,
    lens[i] valid) spliced into row chunk_rows[i]; the last row padded;
    the supervised tail of each row matched by the teacher stream's."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    tok = (-(-lens // compression)).astype(np.int32)
    start, pos = np.zeros(len(lens), np.int32), [2] * rows
    for i, r in enumerate(chunk_rows):
        start[i], pos[r] = pos[r], pos[r] + int(tok[i]) + 1
    ids = rng.integers(1, vocab, (rows, T)).astype(np.int32)
    mask = np.ones((rows, T), np.int32)
    mask[-1, T - 3:] = 0
    alt_ids = rng.integers(1, vocab, (rows, T2)).astype(np.int32)
    alt_mask = np.ones((rows, T2), np.int32)
    alt_mask[0, T2 - 2:] = 0
    labels = np.full((rows, T), -100, np.int32)
    alt_labels = np.full((rows, T2), -100, np.int32)
    for r in range(rows):
        v, av = int(mask[r].sum()), int(alt_mask[r].sum())
        n = min(v - pos[r] - 1, av - 4) - r
        labels[r, v - n:v] = ids[r, v - n:v]
        alt_ids[r, av - n:av] = ids[r, v - n:v]
        alt_labels[r, av - n:av] = ids[r, v - n:v]
    return dict(
        input_ids=ids, attention_mask=mask, labels=labels,
        audio_values=(0.5 * rng.standard_normal((len(lens), 80, T_MEL))).astype(np.float32),
        audio_lens=lens, audio_token_len=tok, audio_token_start_idx=start,
        audio_chunk_batch_idx=np.asarray(chunk_rows, np.int32),
        alt_input_ids=alt_ids, alt_attention_mask=alt_mask, alt_labels=alt_labels)


def concat(batches):
    """The global batch of the ranks' local ones, as the JAX package's
    make_global_batch builds it: text padded to the longest (labels with
    -100), chunks concatenated with their row index made global."""
    out = {}
    for k in TEXT_KEYS:
        width = max(b[k].shape[1] for b in batches)
        fill = -100 if k.endswith("labels") else 0
        out[k] = np.concatenate([np.pad(b[k], ((0, 0), (0, width - b[k].shape[1])),
                                        constant_values=fill) for b in batches])
    offsets = np.cumsum([0] + [b["input_ids"].shape[0] for b in batches[:-1]])
    for k in CHUNK_KEYS:  # a text-only batch has no chunks
        out[k] = np.concatenate([b[k] + (o if k == "audio_chunk_batch_idx" else 0)
                                 for b, o in zip(batches, offsets) if k in b])
    return out


def world2_batches(step):
    """Rank 0: 2 rows of 32 tokens, one chunk each; rank 1: 2 rows of 40
    tokens, 3 chunks (two in row 0)."""
    return [local_batch(10 * step, 2, 32, 20, [0, 1], [160, 120]),
            local_batch(10 * step + 1, 2, 40, 24, [0, 0, 1], [160, 96, 144])]


def mixed_batches(step):
    """world2_batches with rank 1's batch text-only (as the collator gives
    a batch in which no sample has audio: no chunk keys)."""
    a, b = world2_batches(step)
    return [a, {k: v for k, v in b.items() if k not in CHUNK_KEYS}]


def world4_batches(step):
    return [local_batch(10 * step + r, 2, 28 + 4 * r, 18 + 2 * r, [0, 1] + [0] * (r % 2),
                        [160, 112] + [80] * (r % 2)) for r in range(4)]


def _loss_configs():
    return (jc.LossConfig(loss_function=jc.LossFunction.KL_DIVERGENCE),
            tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE))


@functools.lru_cache(maxsize=None)
def jax_run(world, steps, accum=1):
    """JAX's steps on the world's (data, fsdp) mesh, on the global batches
    of its first ``steps`` steps: (metrics, trainables, the magnitude of
    the clipped gradient of the first update, with accumulation the mean
    over its micro-steps). That gradient is read off the update itself:
    Adam's first update moves an element by lr (g / (|g| + eps) + decay x
    p), so |g| / (|g| + eps) is known and |g| with it. JAX runs without
    remat (the same values)."""
    _, batches, data, fsdp = {**WORLDS, **MIXED}[world]
    jcfg, _ = configs()
    jp = jax_params(jcfg)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=data, fsdp=fsdp, tensor=1, pipe=1),
                           jax.devices()[: data * fsdp])
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


def assert_metrics(got, want, rtol=METRIC_RTOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"step {i} {k}")


def assert_trainables(got, want, grad):
    """Within PARAM_ATOL where the clipped gradient exceeds GRAD_FLOOR
    (Adam moves an element by about lr g / (|g| + eps), so one whose
    gradient is near eps or rounding noise may differ by up to 2 lr), over
    90% of the elements."""
    assert sorted(got) == sorted(want)
    compared = total = 0
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.shape == w.shape, k
        big = grad[k] > GRAD_FLOOR
        compared, total = compared + big.sum(), total + big.size
        np.testing.assert_allclose(g[big], w[big], rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert compared > 0.9 * total


def port_run(tcfg, np_params, global_batches, accum=1, resume=None, save_at=None):
    """The port's steps in this process (one process, no group): metrics
    and the state; with ``save_at`` a checkpoint (and export) into that
    (dir, step)."""
    opt = tts.make_optimizer(LR, **OPT)
    if accum > 1:
        opt = tts.multi_steps(opt, accum)
    state, template = tts.init_train_state(from_jax_params(np_params, tcfg), opt, TRAINABLE,
                                           device="cpu")
    if resume:
        state = tckpt.restore_checkpoint(resume, state)
    step = tts.make_train_step(tcfg, _loss_configs()[1], opt, template, remat=True,
                               attn_impl="flash", vocab_chunk=CHUNK)
    metrics = []
    for b in global_batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if save_at and state.step == save_at[1]:
            tckpt.save_checkpoint(save_at[0], state)
    return metrics, state


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def world1(setup, tmp_path_factory):
    """Three uninterrupted world-1 steps on the world-2 global batches,
    checkpoint-2 saved on the way."""
    _, tcfg, _, npp = setup
    d = str(tmp_path_factory.mktemp("world1"))
    metrics, state = port_run(tcfg, npp, [concat(world2_batches(s)) for s in range(3)],
                              save_at=(d, 2))
    return d, metrics, {k: v.detach().clone() for k, v in state.trainable.items()}


@pytest.fixture(scope="module")
def world2(setup, world1, tmp_path_factory):
    """One gloo group of 2 ranks (fsdp 2): a step, an accumulated update,
    the planted fault, 2 steps saved, and a resume of world 1's checkpoint."""
    _, tcfg, _, npp = setup
    d = str(tmp_path_factory.mktemp("world2"))
    save = os.path.join(d, "saved")
    runs = [
        {"batches": [world2_batches(0)]},
        {"batches": [world2_batches(0), world2_batches(1)], "accum": 2},
        {"batches": [world2_batches(0)], "fault": "mean_of_means"},
        {"batches": [world2_batches(0), world2_batches(1)], "save": save},
        {"batches": [world2_batches(2)], "resume": os.path.join(world1[0], "checkpoint-2")},
        {"batches": [mixed_batches(0)]},
        {"batches": [mixed_batches(0)], "eval": True},
    ]
    ranks = start("step", dict(params=npp, cfg=tcfg, data=1, fsdp=2, lr=LR, opt=OPT,
                               trainable=TRAINABLE, loss_config=_loss_configs()[1],
                               vocab_chunk=CHUNK, runs=runs), os.path.join(d, "run"), world=2)
    return ranks, save


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    _, tcfg, _, npp = setup
    d = str(tmp_path_factory.mktemp("world4"))
    runs = [{"batches": [world4_batches(0)]},
            {"batches": [world4_batches(0), world4_batches(1)], "accum": 2}]
    return start("step", dict(params=npp, cfg=tcfg, data=2, fsdp=2, lr=LR, opt=OPT,
                              trainable=TRAINABLE, loss_config=_loss_configs()[1],
                              vocab_chunk=CHUNK, runs=runs), d, world=4)


WORLDS = {"world2-fsdp2": ("world2", world2_batches, 1, 2),
          "world4-data2xfsdp2": ("world4", world4_batches, 2, 2)}
MIXED = {"world2-fsdp2-mixed": ("world2", mixed_batches, 1, 2)}


def _ranks(request, name):
    """The world's ranks (started in the background by its fixture)."""
    out = request.getfixturevalue(name)
    return out[0] if name == "world2" else out


@pytest.mark.parametrize("world", list(WORLDS))
def test_fsdp_step_and_accumulated_update_match_jax(request, world):
    name, _, data, fsdp = WORLDS[world]
    ranks = _ranks(request, name)
    want = [jax_run(world, 1, 1), jax_run(world, 2, 2)]  # while the ranks run
    out = ranks.result()
    assert out["mesh"] == {"data": data, "fsdp": fsdp, "tensor": 1, "pipe": 1}
    for run, (jm, jtr, grad) in zip(out["runs"][:2], want):
        assert jm[0]["grad_norm"] > OPT["max_grad_norm"]  # clipping ran
        assert_metrics(run["metrics"], jm)
        assert_trainables(run["trainable"], jtr, grad)


@pytest.mark.parametrize("world", list(WORLDS))
def test_each_rank_holds_its_fsdp_slice(setup, request, world):
    jcfg, _, jp, _ = setup
    name, _, data, fsdp = WORLDS[world]
    out = _ranks(request, name).result()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=data, fsdp=fsdp, tensor=1, pipe=1),
                           jax.devices()[: data * fsdp])
    specs = dict(tts._path_items(jax.tree.map(
        tuple, jsh.param_pspecs(jp, jsh.DEFAULT_RULES, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    for rank, facts in enumerate(out["per_rank"]):
        sharded = []
        for path, (storage, nbytes, full, is_shard) in facts["held"][0].items():
            full_bytes = int(np.prod(full)) * 4
            if "fsdp" in specs[path]:
                sharded.append(path)
                assert is_shard and storage == nbytes == full_bytes // fsdp, (rank, path)
            else:
                assert not is_shard and nbytes == full_bytes, (rank, path)
        assert "language_model/layers/q_proj/kernel" in sharded
        assert "language_model/lm_head/kernel" in sharded
        assert "audio_tower/embed_positions" in sharded


def test_ranks_are_ragged():
    a, b = world2_batches(0)
    assert a["input_ids"].shape[1] != b["input_ids"].shape[1]
    assert a["alt_input_ids"].shape[1] != b["alt_input_ids"].shape[1]
    assert len(a["audio_lens"]) != len(b["audio_lens"])
    assert (a["labels"] != -100).sum() != (b["labels"] != -100).sum()


def test_mean_of_rank_means_fails_the_check(world2):
    """The planted fault (each rank normalises by its own count, the ranks'
    losses averaged) gives another loss and other gradients than the
    global batch's: the check above rejects it."""
    out = world2[0].result()
    jm, _, _ = jax_run("world2-fsdp2", 1, 1)
    with pytest.raises(AssertionError):
        assert_metrics(out["runs"][2]["metrics"], jm)
    assert_metrics(out["runs"][0]["metrics"], jm)


def test_ranks_that_differ_in_carrying_audio_match_jax(world2):
    """fsdp 2, rank 0's batch with audio and rank 1's text-only: the ranks
    run the same gathers and reduce-scatters (rank 1 on a dummy chunk), and
    the step equals JAX's on the global batch."""
    a, b = mixed_batches(0)
    assert "audio_values" in a and "audio_values" not in b
    out = world2[0].result()
    jm, jtr, grad = jax_run("world2-fsdp2-mixed", 1, 1)
    run = out["runs"][5]
    assert_metrics(run["metrics"], jm)
    assert_trainables(run["trainable"], jtr, grad)


def test_validation_on_ranks_that_differ_in_carrying_audio(setup, world2):
    """The validation step (``make_eval_step(mesh=)``, as ``validate()``
    runs it) on the same mixed ranks: the (sum, count) added over the ranks
    equal one process's on the global batch."""
    _, tcfg, _, npp = setup
    opt = tts.make_optimizer(LR, **OPT)
    state, template = tts.init_train_state(from_jax_params(npp, tcfg), opt, TRAINABLE,
                                           device="cpu")
    eval_fn = tts.make_eval_step(tcfg, _loss_configs()[1], template, vocab_chunk=CHUNK,
                                 attn_impl="flash")
    s, c = eval_fn(state, {k: torch.from_numpy(v) for k, v in concat(mixed_batches(0)).items()})
    got = world2[0].result()["runs"][6]["metrics"][0]
    assert got["count"] == float(c)
    np.testing.assert_allclose(got["nll_sum"], float(s), rtol=1e-5)


def test_resume_world2_checkpoint_at_world1(setup, world1, world2):
    """Two steps at world 2, saved; the third at world 1 from that
    checkpoint equals the uninterrupted world-1 run's third step."""
    _, tcfg, _, npp = setup
    _, w1_metrics, w1_trainable = world1
    out, save = world2[0].result(), world2[1]
    assert out["runs"][3]["step"] == 2
    metrics, state = port_run(tcfg, npp, [concat(world2_batches(2))],
                              resume=os.path.join(save, "checkpoint-2"))
    assert state.step == 3
    assert_metrics(metrics, w1_metrics[2:])
    for k, v in state.trainable.items():
        np.testing.assert_allclose(v.detach().numpy(), w1_trainable[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_resume_world1_checkpoint_at_world2(world1, world2):
    _, w1_metrics, w1_trainable = world1
    run = world2[0].result()["runs"][4]
    assert run["step"] == 3
    assert_metrics(run["metrics"], w1_metrics[2:])
    for k, v in run["trainable"].items():
        np.testing.assert_allclose(v.numpy(), w1_trainable[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_world2_checkpoint_and_export_are_one_process_files(setup, world2, tmp_path):
    """The world-2 checkpoint holds whole leaves and moments, as one
    process writes them, and the master's export is byte-equal to one
    process's export of the state restored from it."""
    _, tcfg, _, npp = setup
    out, save = world2[0].result(), world2[1]
    payload = torch.load(os.path.join(save, "checkpoint-2", tckpt.STATE_FILE),
                         weights_only=True)
    opt = tts.make_optimizer(LR, **OPT)
    state, _ = tts.init_train_state(from_jax_params(npp, tcfg), opt, TRAINABLE, device="cpu")
    assert {k: tuple(v.shape) for k, v in payload["trainable"].items()} == {
        k: tuple(v.shape) for k, v in state.trainable.items()}
    for k, v in payload["trainable"].items():
        torch.testing.assert_close(v, out["runs"][3]["trainable"][k], rtol=0, atol=0)
    moments = payload["adamw"]["state"]
    for i, v in enumerate(state.trainable.values()):
        assert moments[i]["exp_avg"].shape == v.shape
    restored = tckpt.restore_checkpoint(os.path.join(save, "checkpoint-2"), state)
    tckpt.export_safetensors(restored, str(tmp_path / "one.safetensors"))
    with open(os.path.join(save, "model.safetensors"), "rb") as f, \
            open(tmp_path / "one.safetensors", "rb") as g:
        assert f.read() == g.read()
    assert tsh.shard_of(restored.trainable["projector/linear_1/kernel"]) is None
