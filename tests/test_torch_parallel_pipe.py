"""The port's pipe axis (GPipe over the decoder stack) over several
processes (gloo, on the CPU) against the JAX package on its 8-device CPU
mesh, fp32.

Each world's ranks are spawned once (``tests/torch_dist_worker.py``'s
``pipe`` task: every job on its own mesh in one process group); JAX runs
in this process meanwhile. Held:

- the pipelined hidden states: ``tests/test_pipeline.py``'s setup (4
  layers, B 8, T 16) through ``pipelined_decoder_hidden`` at pipe 2 with M
  2, 4 and 8 and at pipe 4 with M 4 against JAX's, within 1e-5; the
  gradients of mean(h^2) for every parameter and the embeddings at pipe 4,
  M 4, and with ``remat=True`` at pipe 2, within 1e-5 of JAX's (which
  runs without remat: the same values);
- a gemma-3 decoder whose local layers are stage 0's and global layers
  stage 1's (window 4 of 16 positions, its own local rope base) at pipe 2,
  against JAX, forward and gradients; a planted fault, each stage running
  its layers with stage-local indices, fails that check;
- the train step (KL, remat, vocabulary chunks of 16, the projector, the
  audio and text LoRA factors and the final norm trained) and one
  accumulated update (grad accum 2) at world 2 (pipe 2), world 4 (fsdp 2 x
  pipe 2, the recipe's layout halved: 2 rows a batch shard, so each rank
  splits JAX's 4 microbatches into 2) and world 4 (tensor 2 x pipe 2),
  against JAX's step on the same ``MeshConfig``: loss, grad norm and param
  norm within rtol 1e-5, trainables within 1e-5 (the fsdp tests'
  tolerances); a planted fault that counts a whole leaf's gradient on
  every stage (P times) fails that check;
- each rank holds only its stage's layers of every
  ``language_model/layers/`` leaf (JAX's spec puts ``pipe`` on their L
  axis), and pipe peers read the same rows (the same batch coordinate);
- the validation step at pipe 2 adds up to one process's sums; the dense
  KL loss and cross-entropy (dense and chunked) at pipe 2 give one
  process's step and sums;
- checkpoints: saved at pipe 2 and resumed at world 1, and the other way
  round, the next step equals an uninterrupted world-1 run; a save that
  rank 1 reaches after the master wrote it completes on both ranks;
- the engines refuse a mesh with pipeline stages;
- ``python -m ultravox_torch.training.train`` with ``--mesh_pipe 2
  --pipe_microbatches 4`` over two processes logs what one process logs
  (training and validation losses) and writes the same checkpoint.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec

from tests.helpers import make_tiny_tokenizer
from tests.test_torch_parallel_train import (
    CHUNK,
    LR,
    OPT,
    PARAM_ATOL,
    _loss_configs,
    assert_metrics,
    assert_trainables,
    concat,
    configs,
    local_batch,
    world2_batches,
)
from tests.test_torch_train_loop import LOSS_ATOL, LOSS_RTOL, NORM_RTOL, PORT_YAML, _argv, read_log
from tests.torch_dist_worker import start
from ultravox_torch.models import config as tc
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.parallel import pipeline as tpipe
from ultravox_torch.training import checkpoint as tckpt
from ultravox_torch.training import config as ttcfg
from ultravox_torch.training import train as ttrain
from ultravox_torch.training import train_step as tts
from ultravox_tpu.models import DecoderConfig as JDecoderConfig
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import decoder as jdl
from ultravox_tpu.models import lora as jlora
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.parallel import mesh as jmesh
from ultravox_tpu.parallel import multihost as jmh
from ultravox_tpu.parallel import pipeline as jpipe
from ultravox_tpu.parallel import sharding as jsh
from ultravox_tpu.training import train_step as jts

TRAINABLE = (r".*projector/.*", r".*audio_tower/.*lora_[ab]$",
             r".*language_model/layers/.*lora_[ab]$", r".*language_model/norm$")
HIDDEN_TOL = 1e-5
GRAD_TOL = 1e-5


# -- the pipelined hidden states (tests/test_pipeline.py's setup) --------------


def _decoder_cfgs(**kw):
    base = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=4,
                num_heads=4, num_kv_heads=2, head_dim=8)
    base.update(kw)
    return JDecoderConfig(**base), tc.DecoderConfig(**base)


GEMMA3 = dict(arch="gemma3", layer_is_local=(True, True, False, False), sliding_window=4,
              qk_norm=True, use_post_norms=True, scale_embeddings=True,
              rope_local_base_freq=10000.0, rope_theta=1000000.0, query_pre_attn_scalar=16,
              hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True)


@functools.lru_cache(maxsize=None)
def hidden_setup(family="llama"):
    """(JAX config, port config, JAX params, embeds, positions, valid) of
    tests/test_pipeline.py; gemma-3 with its norms away from zero."""
    jcfg, tcfg = _decoder_cfgs(**(GEMMA3 if family == "gemma3" else {}))
    params = jdl.init_params(jcfg, jax.random.key(0))
    if family == "gemma3":
        rng = np.random.default_rng(4)
        params = jax.tree.map(lambda a: a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                                        a.dtype) if a.ndim <= 2 and
                              a.shape[-1] in (8, 32) else a, params)
    B, T = 8, 16
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(1, 128, (B, T)), jnp.int32)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    valid = jnp.asarray([T, T - 3, T, 9, T, T, 12, T], jnp.int32)
    embeds = jdl.embed_lookup(params, ids)
    return jcfg, tcfg, params, embeds, positions, valid


@functools.lru_cache(maxsize=None)
def jax_hidden(family, stages, n_micro, grads=False):
    """JAX's pipelined hidden states (and the gradients of mean(h^2) for the
    parameters and the embeddings) on a ("pipe",) mesh of ``stages``."""
    jcfg, _, params, embeds, positions, valid = hidden_setup(family)
    mesh = JMesh(np.array(jax.devices()[:stages]), ("pipe",))

    def run(p, e):
        return jpipe.pipelined_decoder_hidden(p, jcfg, e, positions, valid, mesh=mesh,
                                              n_micro=n_micro)

    h = np.asarray(jax.jit(run)(params, embeds))
    if not grads:
        return h, None
    loss = lambda p, e: jnp.mean(run(p, e).astype(jnp.float32) ** 2)  # noqa: E731
    _, (gp, ge) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(params, embeds)
    return h, (jax.tree.map(np.asarray, gp), np.asarray(ge))


def _hidden_job(family, pipe, n_micro, grads=False, remat=False, fault=None):
    _, tcfg, params, embeds, positions, valid = hidden_setup(family)
    return dict(kind="hidden", mesh=(1, 1, 1, pipe), cfg=tcfg,
                params=jax.tree.map(np.asarray, params), embeds=np.asarray(embeds),
                positions=np.asarray(positions), valid=np.asarray(valid), n_micro=n_micro,
                grads=grads, remat=remat, fault=fault)


def _flat(tree, prefix=""):
    from ultravox_torch.parallel.sharding import path_items

    return dict(path_items(tree, prefix))


def assert_hidden(got, want):
    h, g = want
    np.testing.assert_allclose(got["hidden"].numpy(), h, rtol=HIDDEN_TOL, atol=HIDDEN_TOL)
    if g is None:
        return
    gp, ge = g
    np.testing.assert_allclose(got["d_embeds"].numpy(), ge, rtol=0, atol=GRAD_TOL)
    flat = _flat(gp)
    assert sorted(got["grads"]) == sorted(flat)
    for k, w in flat.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), w, rtol=0, atol=GRAD_TOL, err_msg=k)


# -- the train step ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pipe_params():
    """tests/test_torch_parallel_train.py's model (2 decoder layers) with
    rank-4 LoRA on q/v in both towers, lora_b away from zero. The language
    model is scaled 2x, not that file's 4x: with the text LoRA and the final
    norm trained too, the 4x model's KL gradient on these batches is
    ill-conditioned in fp32 (the port and JAX each differ from a float64
    evaluation of the port by up to 1.2e-5 a leaf, more than the
    tolerance); at 2x each side is within 3.3e-6 of it."""
    jcfg, _ = configs()
    params = juv.init_params(jcfg, jax.random.key(0))
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 2.0}
    params = {k: jax.tree.map(lambda a, f=scale[k]: a * f if a.ndim >= 2 else a, v)
              for k, v in params.items()}
    lora = jc.LoraConfig(r=4, target_modules=("q_proj", "v_proj"))
    params = jlora.apply_lora_to_model(params, lora, lora, jax.random.key(3))
    rng = np.random.default_rng(9)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype)
        if str(p[-1].key) == "lora_b" else a, params)


def pipe2_batches(step):
    """One batch shard: 4 rows of 32 tokens, 5 chunks (two in row 0)."""
    return [local_batch(10 * step + 7, 4, 32, 20, [0, 0, 1, 2, 3], [160, 96, 144, 120, 80])]


# name: (batches, data, fsdp, tensor, pipe, pipe_micro)
WORLDS = {"world2-pipe2": (pipe2_batches, 1, 1, 1, 2, None),
          "world4-fsdp2xpipe2": (world2_batches, 1, 2, 1, 2, None),
          "world4-tensor2xpipe2": (pipe2_batches, 1, 1, 2, 2, 2)}


@functools.lru_cache(maxsize=None)
def jax_run(world, steps, accum=1):
    """JAX's steps on the world's mesh (pipelined as its recipe asks):
    (metrics, trainables, the clipped gradient's magnitude read off Adam's
    first update), as tests/test_torch_parallel_train.py computes them."""
    batches, data, fsdp, tensor, pipe, micro = WORLDS[world]
    jcfg, _ = configs()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=data, fsdp=fsdp, tensor=tensor, pipe=pipe),
                           jax.devices()[: data * fsdp * tensor * pipe])
    opt = jts.make_optimizer(LR, **OPT)
    if accum > 1:
        opt = optax.MultiSteps(opt, accum)
    state, template = jts.init_train_state(jsh.shard_params(pipe_params(), mesh), opt,
                                           TRAINABLE)
    # the step's outputs are laid over the mesh: so are its inputs, so that
    # the second step reuses the first one's compiled program
    state = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, PartitionSpec()))
                         if isinstance(a.sharding, jax.sharding.SingleDeviceSharding) else a,
                         state)
    p0 = {k: np.asarray(v) for k, v in state.trainable.items()}
    step = jax.jit(jts.make_train_step(jcfg, _loss_configs()[0], opt, template, remat=False,
                                       attn_impl="xla", vocab_chunk=CHUNK, pipe_mesh=mesh,
                                       pipe_micro=micro))
    metrics = []
    for s in range(steps):
        state, m = step(state, jmh.make_global_batch(concat(batches(s)), mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    p1 = {k: np.asarray(v) for k, v in state.trainable.items()}
    eps = 1e-8
    ratio = {k: np.clip(np.abs((p0[k] - p1[k]) / LR - OPT["weight_decay"] * p0[k]), 0, 1 - 1e-7)
             for k in p0}
    return metrics, p1, {k: eps * r / (1 - r) for k, r in ratio.items()}


def _port_loss(loss):
    return tc.LossConfig(loss_function=tc.LossFunction.CROSS_ENTROPY if loss == "ce"
                         else tc.LossFunction.KL_DIVERGENCE)


def _step_job(world, runs, loss="kl", chunk=CHUNK, trainable=TRAINABLE):
    _, data, fsdp, tensor, pipe, micro = WORLDS[world]
    _, tcfg = configs()
    return dict(kind="step", mesh=(data, fsdp, tensor, pipe),
                params=jax.tree.map(np.asarray, pipe_params()), cfg=tcfg, lr=LR, opt=OPT,
                trainable=trainable, loss_config=_port_loss(loss), vocab_chunk=chunk,
                pipe_micro=micro, runs=runs)


def port_run(global_batches, accum=1, resume=None, save_at=None, eval_only=False, loss="kl",
             chunk=CHUNK):
    """The port's steps in this process (one process, no group)."""
    _, tcfg = configs()
    opt = tts.make_optimizer(LR, **OPT)
    if accum > 1:
        opt = tts.multi_steps(opt, accum)
    npp = jax.tree.map(np.asarray, pipe_params())
    state, template = tts.init_train_state(from_jax_params(npp, tcfg), opt, TRAINABLE,
                                           device="cpu")
    if resume:
        state = tckpt.restore_checkpoint(resume, state)
    if eval_only:
        fn = tts.make_eval_step(tcfg, _port_loss(loss), template, vocab_chunk=chunk,
                                attn_impl="flash")
        return [fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
                for b in global_batches], state
    step = tts.make_train_step(tcfg, _port_loss(loss), opt, template, remat=True,
                               attn_impl="flash", vocab_chunk=chunk)
    metrics = []
    for b in global_batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if save_at and state.step == save_at[1]:
            tckpt.save_checkpoint(save_at[0], state)
    return metrics, state


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """Three uninterrupted world-1 steps on the pipe-2 batches,
    checkpoint-2 saved on the way."""
    d = str(tmp_path_factory.mktemp("world1"))
    metrics, state = port_run([concat(pipe2_batches(s)) for s in range(3)], save_at=(d, 2))
    return d, metrics, {k: v.detach().clone() for k, v in state.trainable.items()}


@pytest.fixture(scope="module")
def world2(world1, tmp_path_factory):
    """One gloo group of 2 ranks: the pipe-2 hidden states (M 2, 4, 8;
    remat), gemma-3 and its fault; the pipe-2 step, an accumulated update,
    the P-times fault, validation, 2 steps saved and a resume of world 1's
    checkpoint."""
    d = str(tmp_path_factory.mktemp("pipe2"))
    save = os.path.join(d, "saved")
    b = pipe2_batches
    jobs = [_hidden_job("llama", 2, m) for m in (2, 4, 8)] + [
        _hidden_job("llama", 2, 4, grads=True, remat=True),
        _hidden_job("gemma3", 2, 4, grads=True),
        _hidden_job("gemma3", 2, 4, fault="local_index"),
        _step_job("world2-pipe2", [
            {"batches": [b(0)]},
            {"batches": [b(0), b(1)], "accum": 2},
            {"batches": [b(0)], "fault": "pipe_p_times"},
            {"batches": [b(0)], "eval": True},
            {"batches": [b(0), b(1)], "save": save},
            {"batches": [b(2)], "resume": os.path.join(world1[0], "checkpoint-2")},
        ])] + [_step_job("world2-pipe2", [{"batches": [b(0)]}, {"batches": [b(0)], "eval": True}],
                         loss=loss, chunk=chunk) for loss, chunk in LOSSES.values()] + [
        # last: whole trainables only, so no gather orders the ranks before
        # the master writes, and rank 1 reaches the save after the write
        _step_job("world2-pipe2", [{"batches": [b(0)], "save": os.path.join(d, "late"),
                                    "late": True}], trainable=(r".*projector/.*",))]
    return start("pipe", {"jobs": jobs}, os.path.join(d, "run"), world=2, timeout=400), save


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One gloo group of 4 ranks: the pipe-4 hidden states and gradients,
    then fsdp 2 x pipe 2 and tensor 2 x pipe 2 steps and accumulated
    updates."""
    d = str(tmp_path_factory.mktemp("world4"))
    jobs = [_hidden_job("llama", 4, 4, grads=True)]
    for world in ("world4-fsdp2xpipe2", "world4-tensor2xpipe2"):
        b = WORLDS[world][0]
        jobs.append(_step_job(world, [{"batches": [b(0)]},
                                      {"batches": [b(0), b(1)], "accum": 2}]))
    return start("pipe", {"jobs": jobs}, d, world=4, timeout=400)


# name: (loss, vocabulary chunk) of the pipe-2 runs held against one process
LOSSES = {"kl-dense": ("kl", None), "ce-chunked": ("ce", CHUNK), "ce-dense": ("ce", None)}
W2_JOBS = {"llama-2-2": 0, "llama-2-4": 1, "llama-2-8": 2, "remat": 3, "gemma3": 4,
           "gemma3-fault": 5, "step": 6, **{k: 7 + i for i, k in enumerate(LOSSES)}, "late": 10}
W4_JOBS = {"llama-4-4": 0, "world4-fsdp2xpipe2": 1, "world4-tensor2xpipe2": 2}


def _world2(world2):
    return world2[0].result()


@pytest.mark.parametrize("n_micro", [2, 4, 8])
def test_pipe2_hidden_matches_jax(world2, n_micro):
    want = jax_hidden("llama", 2, n_micro)
    assert_hidden(_world2(world2)["jobs"][W2_JOBS[f"llama-2-{n_micro}"]], want)


def test_pipe4_hidden_and_gradients_match_jax(world4):
    want = jax_hidden("llama", 4, 4, grads=True)
    assert_hidden(world4.result()["jobs"][W4_JOBS["llama-4-4"]], want)


def test_pipe2_remat_gradients_match_jax(world2):
    want = jax_hidden("llama", 2, 4, grads=True)
    assert_hidden(_world2(world2)["jobs"][W2_JOBS["remat"]], want)


def test_gemma3_local_and_global_stages_match_jax(world2):
    assert hidden_setup("gemma3")[0].layer_is_local == (True, True, False, False)
    want = jax_hidden("gemma3", 2, 4, grads=True)
    out = _world2(world2)["jobs"]
    assert_hidden(out[W2_JOBS["gemma3"]], want)
    with pytest.raises(AssertionError):  # stage-local indices: stage 1 runs its layers local
        assert_hidden(out[W2_JOBS["gemma3-fault"]], (want[0], None))


@pytest.mark.parametrize("world", list(WORLDS))
def test_pipe_step_and_accumulated_update_match_jax(request, world2, world4, world):
    _, data, fsdp, tensor, pipe, _ = WORLDS[world]
    want = [jax_run(world, 1, 1), jax_run(world, 2, 2)]  # while the ranks run
    job = (_world2(world2)["jobs"][W2_JOBS["step"]] if world == "world2-pipe2"
           else world4.result()["jobs"][W4_JOBS[world]])
    assert job["mesh"] == {"data": data, "fsdp": fsdp, "tensor": tensor, "pipe": pipe}
    for run, (jm, jtr, grad) in zip(job["runs"][:2], want):
        assert jm[0]["grad_norm"] > OPT["max_grad_norm"]  # clipping ran
        assert_metrics(run["metrics"], jm)
        assert_trainables(run["trainable"], jtr, grad)


def test_whole_leaf_gradient_counted_on_every_stage_fails_the_check(world2):
    run = _world2(world2)["jobs"][W2_JOBS["step"]]["runs"]
    jm, _, _ = jax_run("world2-pipe2", 1, 1)
    with pytest.raises(AssertionError):
        assert_metrics(run[2]["metrics"], jm)
    assert_metrics(run[0]["metrics"], jm)


@pytest.mark.parametrize("world", list(WORLDS))
def test_each_rank_holds_its_stage_layers_and_reads_its_rows(world2, world4, world):
    batches, data, fsdp, tensor, pipe, _ = WORLDS[world]
    ranks = (world2[0] if world == "world2-pipe2" else world4).result()["per_rank"]
    job = W2_JOBS["step"] if world == "world2-pipe2" else W4_JOBS[world]
    jmesh_ = jmesh.make_mesh(jmesh.MeshConfig(data=data, fsdp=fsdp, tensor=tensor, pipe=pipe),
                             jax.devices()[: data * fsdp * tensor * pipe])
    specs = dict(_flat(jax.tree.map(
        tuple, jsh.param_pspecs(pipe_params(), jsh.rules_for_mesh(jmesh_), jmesh_),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    L = configs()[1].text_config.num_layers
    rows = {}
    for rank, facts in enumerate(ranks):
        facts = facts[job]
        stage = facts["coords"]["pipe"]
        layer_leaves = 0
        for path, (offset, shape) in facts["stage"][0].items():
            if path.startswith("language_model/layers/"):
                layer_leaves += 1
                assert specs[path][:1] == ("pipe",), path
                assert offset == stage * L // pipe and shape[0] == L // pipe, (rank, path)
            else:
                assert offset is None and "pipe" not in specs[path], (rank, path)
        assert layer_leaves >= 12
        for path, (storage, nbytes, full, _) in facts["held"][0].items():
            spec = specs[path]
            parts = ((pipe if "pipe" in spec else 1) * (tensor if "tensor" in spec else 1)
                     * (fsdp if "fsdp" in spec else 1))
            assert storage == nbytes == int(np.prod(full)) * 4 // parts, (rank, path)
        rows.setdefault((facts["coords"]["data"], facts["coords"]["fsdp"]), set()).add(
            facts["rows"])
    assert len(rows) == data * fsdp
    for peers in rows.values():  # tensor and pipe peers read one batch coordinate
        assert len(peers) == 1


def test_validation_at_pipe2_matches_one_process(world2):
    (s, c), = port_run([concat(pipe2_batches(0))], eval_only=True)[0]
    got = _world2(world2)["jobs"][W2_JOBS["step"]]["runs"][3]["metrics"][0]
    assert got["count"] == float(c) > 0
    np.testing.assert_allclose(got["nll_sum"], float(s), rtol=1e-5)


@pytest.mark.parametrize("loss", list(LOSSES))
def test_pipe2_other_losses_match_one_process(world2, loss):
    """The dense KL loss and cross-entropy (dense and chunked) at pipe 2: a
    step and the validation sums equal one process's (the KL chunked one
    is held against JAX above)."""
    name, chunk = LOSSES[loss]
    b = concat(pipe2_batches(0))
    want, _ = port_run([b], loss=name, chunk=chunk)
    (s, c), = port_run([b], eval_only=True, loss=name, chunk=chunk)[0]
    runs = _world2(world2)["jobs"][W2_JOBS[loss]]["runs"]
    assert_metrics(runs[0]["metrics"], want)
    got = runs[1]["metrics"][0]
    assert got["count"] == float(c) > 0
    np.testing.assert_allclose(got["nll_sum"], float(s), rtol=1e-5)


def test_resume_pipe2_checkpoint_at_world1(world1, world2):
    """Two steps at pipe 2, saved; the third at world 1 from that
    checkpoint equals the uninterrupted world-1 run's third step (the text
    LoRA factors are stage slices, gathered whole into the file)."""
    _, w1_metrics, w1_trainable = world1
    out, save = _world2(world2)["jobs"][W2_JOBS["step"]], world2[1]
    assert out["runs"][4]["step"] == 2
    payload = torch.load(os.path.join(save, "checkpoint-2", tckpt.STATE_FILE),
                         weights_only=True)
    lora = "language_model/layers/q_proj/lora_a"
    assert payload["trainable"][lora].shape[0] == configs()[1].text_config.num_layers
    metrics, state = port_run([concat(pipe2_batches(2))],
                              resume=os.path.join(save, "checkpoint-2"))
    assert state.step == 3
    assert_metrics(metrics, w1_metrics[2:])
    for k, v in state.trainable.items():
        np.testing.assert_allclose(v.detach().numpy(), w1_trainable[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_save_when_the_master_wrote_first(world2):
    """A rank that reaches ``save_checkpoint`` after the master has written
    the directory still joins its barrier (it used to return at once, and
    the master waited for ever); the file is one process's."""
    out = _world2(world2)["jobs"][W2_JOBS["late"]]["runs"][0]
    path = os.path.join(os.path.dirname(world2[1]), "late", "checkpoint-1", tckpt.STATE_FILE)
    payload = torch.load(path, weights_only=True)
    assert out["step"] == payload["step"] == 1
    for k, v in payload["trainable"].items():
        torch.testing.assert_close(v, out["trainable"][k], rtol=0, atol=0)


def test_resume_world1_checkpoint_at_pipe2(world1, world2):
    _, w1_metrics, w1_trainable = world1
    run = _world2(world2)["jobs"][W2_JOBS["step"]]["runs"][5]
    assert run["step"] == 3
    assert_metrics(run["metrics"], w1_metrics[2:])
    for k, v in run["trainable"].items():
        np.testing.assert_allclose(v.numpy(), w1_trainable[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_microbatch_errors_match_jax():
    """The stage count must divide the layers and the microbatch count the
    global batch, with the JAX package's messages."""
    from ultravox_torch.parallel import mesh as tmesh

    _, tcfg, params, embeds, positions, valid = hidden_setup()
    lm = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), params)
    e, p, v = (torch.from_numpy(np.asarray(a).copy()) for a in (embeds, positions, valid))
    mesh3 = tmesh.Mesh.local(tmesh.MeshConfig(1, 1, 1, 3), 3)
    with pytest.raises(ValueError, match="not divisible by 3 pipeline stages"):
        tpipe.pipelined_decoder_hidden(lm, tcfg, e, p, v, mesh=mesh3)
    mesh2 = tmesh.Mesh.local(tmesh.MeshConfig(1, 2, 1, 2), 4)
    with pytest.raises(ValueError, match="batch 16 not divisible by n_micro=3"):
        tpipe.pipelined_decoder_hidden(lm, tcfg, e, p, v, mesh=mesh2, n_micro=3)
    assert [tpipe.default_n_micro(b, 2) for b in (8, 6, 4, 2, 3)] == [8, 6, 4, 2, 2]


def test_engines_refuse_pipe_stages():
    """No engine runs pipeline stages (the JAX package's engines neither):
    a mesh with pipe 2 raises before any weight is placed."""
    from ultravox_torch.inference.engine import GenerationEngine
    from ultravox_torch.inference.serving.engine import ServingEngine
    from ultravox_torch.parallel import mesh as tmesh

    _, tcfg = configs()
    mesh = tmesh.Mesh.local(tmesh.MeshConfig(1, 1, 1, 2), 2)
    for engine in (GenerationEngine, ServingEngine):
        with pytest.raises(ValueError, match="mesh pipe 1"):
            engine({}, tcfg, mesh=mesh, device="cpu")


# -- the training CLI -----------------------------------------------------------


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """train() on test_train.yaml at pipe 2 over two processes (batch 4, 4
    microbatches, validation every step) and at world 1 in this process."""
    base = tmp_path_factory.mktemp("cli")
    tok = str(base / "tok")
    make_tiny_tokenizer().save_pretrained(tok)
    over = {"report_logs_to": [], "batch_size": 4, "val_sets": ["synthetic-asr"],
            "val_steps": 1, "val_num_samples": 8}
    argv2 = _argv(PORT_YAML, base / "pipe2", tok, dict(over, mesh_pipe=2,
                                                        pipe_microbatches=4)) + ["--device", "cpu"]
    ranks = start("train", dict(argv=argv2), str(base / "run"), world=2)
    ttrain.train(ttcfg.get_train_config(_argv(PORT_YAML, base / "one", tok, over)
                                        + ["--device", "cpu"]))
    ranks.result()
    return base


def test_train_cli_at_pipe2_matches_world1(cli):
    one, two = read_log(cli / "one"), read_log(cli / "pipe2")
    assert [r["step"] for r in two] == [r["step"] for r in one]
    assert any(k.startswith("val_loss/") for r in one for k in r)
    for a, b in zip(one, two):
        assert sorted(a) == sorted(b)
        for k in a:
            if k in ("step", "samples_per_s"):
                continue
            loss = "loss" in k
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL if loss else NORM_RTOL,
                                       atol=LOSS_ATOL if loss else 0.0, err_msg=f"{a['step']} {k}")
    s1 = torch.load(cli / "one" / "checkpoint-2" / "state.pt", weights_only=True)
    s2 = torch.load(cli / "pipe2" / "checkpoint-2" / "state.pt", weights_only=True)
    assert s1["step"] == s2["step"] == 2
    for k, v in s1["trainable"].items():
        torch.testing.assert_close(s2["trainable"][k], v, rtol=0, atol=1e-5, msg=k)
