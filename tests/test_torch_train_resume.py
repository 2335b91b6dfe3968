"""The port's training loop, continued (see tests/test_torch_train_loop.py
for the set-up and the tolerances):

- ``grad_accum_steps: 2`` over 4 micro-steps against the JAX loop's
  ``optax.MultiSteps``, with validation every 2 micro-steps in both logs;
- ``validate()`` against the JAX package's on one state;
- ``audio_latency_block_size: 100`` with the audio tower trainable, so the
  block-causal encoder mask lies on the gradient path;
- resume: 2 micro-steps, a restore, and 2 more give the state of 4 in one
  run bit for bit (trainable leaves, AdamW moments, update count, step,
  the accumulation buffers), with and without accumulation; and the
  checkpoint's save is idempotent per step.
"""

import copy
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_train_loop import (
    LOSS_ATOL,
    LOSS_RTOL,
    assert_logs_match,
    read_log,
    run_jax,
    run_port,
    tokenizer_dir,  # noqa: F401  (a fixture)
)
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.training import checkpoint as tck
from ultravox_torch.training import model_factory as tmf
from ultravox_torch.training import train as ttrain
from ultravox_torch.training import train_step as tts

VAL = {"val_sets": ["synthetic-asr"], "val_steps": 2, "val_num_samples": 3}


def test_grad_accum_matches_multisteps(tmp_path, tokenizer_dir):  # noqa: F811
    jc, params = run_jax(tmp_path / "jax", tokenizer_dir, grad_accum_steps=2, **VAL)
    tc = run_port(tmp_path / "port", tokenizer_dir, params, grad_accum_steps=2, **VAL)
    assert_logs_match(jc.output_dir, tc.output_dir)
    log = read_log(tc.output_dir)
    steps = [r["step"] for r in log if "loss" in r]
    assert steps == [1, 2, 3, 4]  # micro-steps: max_steps 2 x grad_accum_steps 2
    assert [r["step"] for r in log if "val_loss/synthetic-asr" in r] == [2, 4]
    # updates at micro-steps 2 and 4; between them the leaves do not move
    by_step = {r["step"]: r["param_norm"] for r in log if "loss" in r}
    assert by_step[3] == by_step[2] != by_step[1]
    assert sorted(os.listdir(tc.output_dir)) == sorted(os.listdir(jc.output_dir))
    state = torch.load(os.path.join(tc.output_dir, "checkpoint-4", "state.pt"), weights_only=True)
    assert (state["step"], state["count"], state["mini_step"]) == (4, 2, 0)


def test_validate_matches_jax(tmp_path, tokenizer_dir):  # noqa: F811
    from ultravox_tpu.parallel import MeshConfig, make_mesh, shard_params
    from ultravox_tpu.training import config as jcfg
    from ultravox_tpu.training import model_factory as jmf
    from ultravox_tpu.training import train as jtrain
    from ultravox_tpu.training import train_step as jts
    from ultravox_torch.training import config as tcfg
    from tests.test_torch_train_loop import JAX_YAML, PORT_YAML, _argv

    ov = {"val_num_samples": 5, "batch_size": 2}
    jc = jcfg.get_train_config(_argv(JAX_YAML, tmp_path, tokenizer_dir, ov))
    tc = tcfg.get_train_config(_argv(PORT_YAML, tmp_path, tokenizer_dir, ov) + ["--device", "cpu"])
    for split in ("synthetic-asr", ["synthetic-asr", "synthetic-asr"]):
        jc.val_sets = tc.val_sets = split if isinstance(split, list) else [split]
        jp = jmf.create_model_pack(jc)
        mesh = make_mesh(MeshConfig(jc.mesh_data, jc.mesh_fsdp, jc.mesh_tensor, jc.mesh_pipe))
        jstate, jtemplate = jts.init_train_state(shard_params(jp.params, mesh),
                                                 jts.make_optimizer(jc.lr),
                                                 jc.effective_trainable_patterns)
        tp = tmf.create_model_pack(tc)
        tp.params = from_jax_params(jax.tree.map(np.array, jp.params), tp.config, device="cpu")
        tstate, ttemplate = tts.init_train_state(tp.params, tts.make_optimizer(tc.lr),
                                                 tc.effective_trainable_patterns, device="cpu")
        want = jtrain.validate(jc, jp, jstate, jtemplate, mesh)
        got = ttrain.validate(tc, tp, tstate, ttemplate)
        assert sorted(got) == sorted(want) == ["val_loss/synthetic-asr"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=LOSS_ATOL)
            assert got[k] > 1.0  # a per-token NLL at a random init


def test_latency_block_trains_the_audio_tower(tmp_path, tokenizer_dir):  # noqa: F811
    ov = {"audio_latency_block_size": 100,
          "trainable_params": [".*projector/.*", ".*audio_tower/.*"]}
    jc, params = run_jax(tmp_path / "jax", tokenizer_dir, **ov)
    tc = run_port(tmp_path / "port", tokenizer_dir, params, **ov)
    assert_logs_match(jc.output_dir, tc.output_dir)
    with open(os.path.join(tc.output_dir, "train_config.json")) as f:
        assert json.load(f)["audio_latency_block_size"] == 100
    assert tmf.create_model_pack(tc).config.audio_latency_block_size == 100
    state = torch.load(os.path.join(tc.output_dir, "checkpoint-2", "state.pt"), weights_only=True)
    assert any(k.startswith("audio_tower/") for k in state["trainable"])


def _assert_states_equal(a, b):
    assert (a["step"], a["count"], a["mini_step"]) == (b["step"], b["count"], b["mini_step"])
    assert sorted(a["trainable"]) == sorted(b["trainable"])
    for k in a["trainable"]:
        assert torch.equal(a["trainable"][k], b["trainable"][k]), k
    sa, sb = a["adamw"]["state"], b["adamw"]["state"]
    assert sorted(sa) == sorted(sb) and len(sa) == len(a["trainable"])
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["adamw"]["param_groups"] == b["adamw"]["param_groups"]
    assert (a["acc"] is None) == (b["acc"] is None)
    for x, y in zip(a["acc"] or [], b["acc"] or []):
        assert torch.equal(x, y)


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_is_bit_exact(tmp_path, tokenizer_dir, accum):  # noqa: F811
    """A run cut after 2 micro-steps (its checkpoint-2 alone in a directory)
    and resumed from there with the same config ends in the state of 4 in
    one run. 4 samples of data (2 batches, cycled), so the resumed run,
    which starts its data from the top as the JAX package's does, sees the
    batches the one-run loop sees."""
    k = {"num_samples": 4, "grad_accum_steps": accum, "save_steps": 2,
         "max_steps": 4 // accum}  # 4 micro-steps
    whole = run_port(tmp_path / "whole", tokenizer_dir, **k)
    cut = tmp_path / "cut"
    shutil.copytree(os.path.join(whole.output_dir, "checkpoint-2"), cut / "checkpoint-2")
    held = {}
    restore = tck.restore_checkpoint

    def spy(path, state):
        out = restore(path, state)
        opt = out.opt_state
        # the optimizer holds the restored tensors
        assert [id(p) for p in opt.adamw.param_groups[0]["params"]] == [
            id(p) for p in out.trainable.values()]
        assert all(p.requires_grad for p in out.trainable.values())
        held["state"] = out
        held["snapshot"] = {  # as restored, before the loop moves it on
            "step": out.step, "count": opt.count, "mini_step": opt.mini_step,
            "trainable": {k: v.detach().clone() for k, v in out.trainable.items()},
            "adamw": copy.deepcopy(opt.adamw.state_dict()),
            "acc": None if opt.acc is None else [a.clone() for a in opt.acc]}
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tck, "restore_checkpoint", spy)
        resumed = run_port(tmp_path / "resumed", tokenizer_dir, model_load_dir=str(cut),
                           resume_from_load_dir=True, **k)

    def load(out, step):
        return torch.load(os.path.join(out, f"checkpoint-{step}", "state.pt"), weights_only=True)

    snap = held["snapshot"]
    assert (snap["step"], snap["count"]) == (2, 2 // accum)
    _assert_states_equal(snap, load(whole.output_dir, 2))
    _assert_states_equal(load(resumed.output_dir, 4), load(whole.output_dir, 4))
    whole_log = {r["step"]: r for r in read_log(whole.output_dir)}
    log = read_log(resumed.output_dir)
    assert [r["step"] for r in log] == [3, 4]
    for r in log:
        for key in ("loss", "grad_norm", "param_norm"):
            assert r[key] == whole_log[r["step"]][key]
    # idempotent per step: saving step 2 again keeps the first write
    state = held["state"]
    with torch.no_grad():
        for v in state.trainable.values():
            v.add_(1.0)
    path = tck.save_checkpoint(str(cut), dataclasses.replace(state, step=2))
    assert path == os.path.join(os.path.abspath(cut), "checkpoint-2")
    _assert_states_equal(load(cut, 2), load(whole.output_dir, 2))
