"""The port's evaluation suite against the JAX package's, on the CPU, in
one process and over two (gloo).

- Every metric of the registries (``wer``, ``cer``, ``bleu``, the sample
  metrics, VoiceBench's rule-based scorers, ``ifeval``) and the English
  normaliser on the inputs of tests/test_evaluation.py and
  tests/test_ifeval.py: the same scores, exactly (the GPT-judge metrics
  are held in tests/test_torch_judge.py).
- ``eval_datasets`` on ``synthetic-asr`` (6 samples, batch 2, greedy, 4
  tokens, with and without the ``null`` augmentation) through both
  packages' ``UltravoxInference`` on the checkpoint of
  tests/assets/tiny_ultravox in fp32: the same answers, scores and JSON
  files; at world 2 (mod-N shards, gathered by index) the same ordered
  output, written by rank 0 alone.
- ``train()`` of ``test_train.yaml`` (KL, 2 steps) with validation and
  ``do_eval``: the port in one process against the JAX package's loop on
  the same initial weights (``eval/<tag>`` equal, ``val_loss`` within
  rtol 1e-5), and the port at world 2 with ``mesh_fsdp: 2`` against its
  own world-1 run: the logged metrics within the tolerances of
  tests/test_torch_train_loop.py (loss rtol 1e-5 + atol 1e-6, norms rtol
  1e-5), ``val_loss`` within rtol 1e-5, the checkpoint's AdamW moments
  within rtol 1e-4 and its leaves within 1e-6 save for at most 0.1% of
  them (each within 2 lr a step), the same files and ``eval/<tag>``; a
  val set of 1 sample at world 2 refused on both ranks (neither waits in
  a gather for the other).
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_tiny_tokenizer
from tests.test_torch_train_loop import (
    JAX_YAML,
    LOSS_ATOL,
    LOSS_RTOL,
    NORM_RTOL,
    PORT_YAML,
    _argv,
    read_log,
)
from tests.torch_dist_worker import start
from ultravox_torch.evaluation import eval as teval
from ultravox_torch.evaluation import ifeval as tifeval
from ultravox_torch.evaluation import metrics as tmetrics
from ultravox_torch.evaluation import string_metrics as tsm
from ultravox_torch.evaluation import voicebench as tvb  # noqa: F401  (registers its metrics)
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.training import config as tcfg
from ultravox_torch.training import train as ttrain
from ultravox_tpu.evaluation import eval as jeval
from ultravox_tpu.evaluation import ifeval as jifeval
from ultravox_tpu.evaluation import metrics as jmetrics
from ultravox_tpu.evaluation import string_metrics as jsm
from ultravox_tpu.evaluation import voicebench as jvb  # noqa: F401
from ultravox_tpu.training import config as jcfg
from ultravox_tpu.training import train as jtrain

FIXTURE = "tests/assets/tiny_ultravox"

# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

CORPUS_CASES = [  # (references, hypotheses, args) of tests/test_evaluation.py and more
    (["hello world"], ["hello world"], {}),
    (["hello world"], ["hello there"], {}),
    (["Hello, world!"], ["hello world"], {}),
    (["do not do that"], ["don't do that"], {}),
    (["你好世界"], ["你好世情"], {"lang_id": "zh"}),
    (["two words"], ["word " * 100], {}),
    (["abcd"], ["abed"], {}),
    (["the cat sat on the mat", "dogs bark loudly"], ["the cat sat on the mat", "dogs bark"], {}),
    (["the cat sat on the mat", "dogs bark loudly"], ["x y z", "a b c"], {}),
    (["it costs $25.33", "the 121st time", "50% done"],
     ["It costs twenty-five dollars and thirty-three cents!",
      "The one hundred and twenty-first time.", "fifty percent done"], {"lang_id": "en"}),
    (["مَرْحَبًا بِكُمْ"], ["مرحبا بكم"], {"lang_id": "ar"}),
    (["Bonjour à tous"], ["bonjour a tous"], {"lang_id": "fr"}),
    (["yes", "no"], ["yes", "yes"], {}),
]

SAMPLE_CASES = [  # (expected, generated) pairs for the sample metrics
    ("True", "I think True."), ("True", "False"), ("yes", "yes"), ("no", "yes"),
    ("B", "The answer is B."), ("Paris||City of Light", "It's in Paris, France."),
    ("", "I can't help with that request."),
    ('{"instruction_id_list": ["punctuation:no_comma"], "kwargs": [{}]}', "no commas at all"),
    ('{"instruction_id_list": ["change_case:english_lowercase", "startend:quotation"], '
     '"kwargs": [{}, {}]}', "Sure! Here you go:\nall lower text"),
    ("C", "I choose C because"), ("A", "no letters here"), ("Rome", "the capital is rome"),
]


def _samples(mod):
    return [mod.EvalSample(i, "q", e, g) for i, (e, g) in enumerate(SAMPLE_CASES)]


def test_metric_registries_match_jax():
    assert sorted(tmetrics.CORPUS_METRIC_REGISTRY) == sorted(jmetrics.CORPUS_METRIC_REGISTRY)
    assert sorted(tmetrics.METRIC_REGISTRY) == sorted(jmetrics.METRIC_REGISTRY)


@pytest.mark.parametrize("case", range(len(CORPUS_CASES)))
@pytest.mark.parametrize("metric", ["wer", "cer", "bleu"])
def test_corpus_metrics_match_jax(metric, case):
    refs, hyps, args = CORPUS_CASES[case]

    def score(mod):
        samples = [mod.EvalSample(i, "q", r, h) for i, (r, h) in enumerate(zip(refs, hyps))]
        return mod.evaluate_answers(samples, metric, dict(args))

    got, want = score(tmetrics), score(jmetrics)
    assert got["score"] == want["score"] and got["per_sample"] is want["per_sample"] is None


@pytest.mark.parametrize("metric", sorted(m for m in jmetrics.METRIC_REGISTRY
                                          if m != "voicebench_open"))
def test_sample_metrics_match_jax(metric):
    got = tmetrics.evaluate_answers(_samples(tmetrics), metric)
    want = jmetrics.evaluate_answers(_samples(jmetrics), metric)
    assert got["score"] == want["score"]
    assert [(r.score, r.reason) for r in got["per_sample"]] == [
        (r.score, r.reason) for r in want["per_sample"]]


def test_english_normaliser_matches_jax():
    texts = [t for refs, hyps, _ in CORPUS_CASES for t in refs + hyps] + [
        "twenty-five", "the one hundred and twenty-first time", "on May third nineteen eighty-four",
        "my favourite colour is grey", "Mr. Smith's 3 o'clock (aside) [noise] hmm, 1,000,000!",
        "one point five million dollars", "two thirds of the 2nd", "£3.50 and €12"]
    for t in texts:
        assert tsm.english_normalize(t) == jsm.english_normalize(t), t
        assert tsm.basic_normalize(t) == jsm.basic_normalize(t), t


def _ifeval_cases():
    from tests import test_ifeval

    mark = next(m for m in test_ifeval.test_checkers.pytestmark if m.name == "parametrize")
    return mark.args[1]


def test_ifeval_checkers_match_jax():
    assert sorted(tifeval.CHECKERS) == sorted(jifeval.CHECKERS)
    for inst, kw, good, bad in _ifeval_cases():
        for text in (good, bad, good.upper(), "*" + bad + "*\n"):
            for strict in (True, False):
                assert (tifeval.evaluate_instructions(text, [inst], [kw], strict=strict)
                        == jifeval.evaluate_instructions(text, [inst], [kw], strict=strict)), inst
    samples = [
        {"response": "my answer is yes.", "kwargs": [{}, {}], "instruction_id_list": [
            "detectable_format:constrained_response", "change_case:english_lowercase"]},
        {"response": "NO COMMAS", "kwargs": [{}, {}],
         "instruction_id_list": ["punctuation:no_comma", "startend:quotation"]},
    ]
    for strict in (True, False):
        assert tifeval.ifeval_score(samples, strict) == jifeval.ifeval_score(samples, strict)


def test_unknown_metric_raises_key_error():
    with pytest.raises(KeyError, match="unknown metric"):
        tmetrics.evaluate_answers(_samples(tmetrics)[:1], "no_such_metric")


# ---------------------------------------------------------------------------
# eval_datasets through both packages' front doors
# ---------------------------------------------------------------------------

EVAL = dict(eval_sets=["synthetic-asr"], num_samples=6, batch_size=2, max_tokens=4,
            augmentations=["null"])


def _read_outputs(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = json.load(f)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt")
    for name in ("config.json", "model.safetensors"):
        shutil.copy(f"{FIXTURE}/{name}", out / name)
    make_tiny_tokenizer().save_pretrained(out)
    return str(out)


@pytest.fixture(scope="module")
def evals(ckpt, tmp_path_factory):
    """(world-2 ranks, the port's world-1 run, JAX's run): (scores, files)."""
    from ultravox_torch.inference.ultravox_infer import UltravoxInference
    from ultravox_tpu.inference.ultravox_infer import UltravoxInference as JUltravoxInference

    base = tmp_path_factory.mktemp("evals")
    ranks = start("eval", dict(model=ckpt, eval_config=teval.EvalConfig(
        output_dir=str(base / "world2"), **EVAL)), str(base / "run"), world=2)
    port = UltravoxInference(ckpt, dtype=torch.float32, max_cache_len=256, device="cpu")
    t = teval.eval_datasets(port, teval.EvalConfig(output_dir=str(base / "port"), **EVAL))
    jax_inf = JUltravoxInference(ckpt, dtype=jnp.float32, max_cache_len=256)
    j = jeval.eval_datasets(jax_inf, jeval.EvalConfig(output_dir=str(base / "jax"), **EVAL))
    return ranks, base, (t, _read_outputs(base / "port")), (j, _read_outputs(base / "jax"))


def test_eval_datasets_matches_jax(evals):
    _, _, (t, tfiles), (j, jfiles) = evals
    assert t == j and sorted(t) == ["synthetic-asr", "synthetic-asr.null"]
    assert tfiles == jfiles
    assert sorted(tfiles) == ["summary.json", "synthetic-asr.json", "synthetic-asr.null.json"]
    samples = tfiles["synthetic-asr.json"]["samples"]
    assert [s["index"] for s in samples] == list(range(6))
    assert len({s["generated_answer"] for s in samples}) > 1  # greedy answers that vary


def test_eval_datasets_at_world2_matches_one_process(evals):
    """Rank 0 runs samples 0, 2, 4 and rank 1 samples 1, 3, 5 (batches of
    2, then 1); the gathered output is the one process's, in index order,
    and only rank 0 scores and writes."""
    ranks, base, (t, tfiles), _ = evals
    out = ranks.result()
    r0, r1 = out["per_rank"]
    assert r0["scores"] == t and r1["scores"] == {}
    assert r0["batches"] == r1["batches"] == [2, 1, 2, 1]
    assert _read_outputs(base / "world2") == tfiles


# ---------------------------------------------------------------------------
# train() with validation and do_eval, one process and two
# ---------------------------------------------------------------------------

TRAIN = {"val_sets": ["synthetic-asr"], "val_steps": 2, "val_num_samples": 4,
         "do_eval": True, "eval_sets": ["synthetic-asr"], "eval_num_samples": 4,
         "eval_batch_size": 2, "eval_max_tokens": 4, "report_logs_to": []}


@pytest.fixture(scope="module")
def trains(tmp_path_factory):
    """JAX's train() and the port's on its initial weights in this
    process, the port's at world 2 (fsdp 2) in two."""
    import jax

    base = tmp_path_factory.mktemp("trains")
    tok = str(base / "tok")
    make_tiny_tokenizer().save_pretrained(tok)
    cfg = jcfg.get_train_config(_argv(JAX_YAML, base / "jax", tok, TRAIN))
    held = {}
    make = jtrain.create_model_pack

    def pack(c):
        p = make(c)
        held["params"] = jax.tree.map(np.array, p.params)
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "create_model_pack", pack)
        jmetrics_ = jtrain.train(cfg)
    params = held["params"]
    argv2 = _argv(PORT_YAML, base / "world2", tok, dict(TRAIN, mesh_fsdp=2)) + ["--device", "cpu"]
    ranks = start("train", dict(argv=argv2, params=params), str(base / "run"), world=2)

    config1 = tcfg.get_train_config(_argv(PORT_YAML, base / "port", tok, TRAIN)
                                    + ["--device", "cpu"])
    make_t = ttrain.create_model_pack

    def tpack(c):
        p = make_t(c)
        p.params = from_jax_params(params, p.config, device="cpu")
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "create_model_pack", tpack)
        tmetrics1 = ttrain.train(config1)
    return base, jmetrics_, tmetrics1, ranks


def test_do_eval_matches_jax(trains):
    base, jm, tm, _ = trains
    assert set(k for k in tm if k.startswith("eval/")) == {"eval/synthetic-asr"}
    assert tm["eval/synthetic-asr"] == jm["eval/synthetic-asr"]
    assert sorted(os.listdir(base / "port" / "eval")) == sorted(os.listdir(base / "jax" / "eval"))
    jv = [r for r in read_log(base / "jax") if "val_loss/synthetic-asr" in r]
    tv = [r for r in read_log(base / "port") if "val_loss/synthetic-asr" in r]
    assert len(tv) == len(jv) == 1
    np.testing.assert_allclose(tv[0]["val_loss/synthetic-asr"], jv[0]["val_loss/synthetic-asr"],
                               rtol=1e-5)


def test_train_at_world2_matches_world1(trains):
    base, _, tm, ranks = trains
    out = ranks.result()
    w2 = out["per_rank"]
    assert w2[0]["metrics"]["eval/synthetic-asr"] == tm["eval/synthetic-asr"]
    assert not any(k.startswith("eval/") for k in w2[1]["metrics"])  # the master scores
    one, two = read_log(base / "port"), read_log(base / "world2")
    assert [r["step"] for r in two] == [r["step"] for r in one]
    for a, b in zip(one, two):
        assert set(a) == set(b)
        for k in a:
            if k in ("step", "samples_per_s"):
                continue
            if "val_loss" in k:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
                continue
            loss = "loss" in k
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL if loss else NORM_RTOL,
                                       atol=LOSS_ATOL if loss else 0.0, err_msg=f"{a['step']} {k}")
    assert sorted(os.listdir(base / "world2")) == sorted(os.listdir(base / "port"))
    s1 = torch.load(base / "port" / "checkpoint-2" / "state.pt", weights_only=True)
    s2 = torch.load(base / "world2" / "checkpoint-2" / "state.pt", weights_only=True)
    assert s1.keys() == s2.keys() and s1["step"] == s2["step"] == 2
    # the moments are the gradients' running means, held like the norms;
    # the leaves within 1e-6 save for at most 0.1% of the elements, each
    # within 2 lr a step: an element whose gradient was near Adam's eps at
    # some step moves by lr g / (|g| + eps) there, as sensitive to rounding
    # as tests/test_torch_train.py says
    lr, far, total = 1e-3, 0, 0
    for i, (k, v) in enumerate(s1["trainable"].items()):
        m1, m2 = s1["adamw"]["state"][i], s2["adamw"]["state"][i]
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(m2[name], m1[name], rtol=1e-4, atol=1e-10, msg=k)
        diff = (s2["trainable"][k] - v).abs()
        assert float(diff.max()) <= 2 * lr * 2, k
        far, total = far + int((diff > 1e-6).sum()), total + v.numel()
    assert far <= 1e-3 * total
    with open(base / "world2" / "train_config.json") as f:
        assert json.load(f)["mesh_fsdp"] == 2


def test_val_set_smaller_than_world_fails_on_every_rank(tmp_path):
    """validate() at world 2 with fsdp 2 on a val set of 1 sample: one rank
    has no batch. Both ranks raise the ValueError; none goes on into the
    forward's gathers and waits there for the other."""
    tok = str(tmp_path / "tok")
    make_tiny_tokenizer().save_pretrained(tok)
    argv = _argv(PORT_YAML, tmp_path / "out", tok, {
        "mesh_fsdp": 2, "max_steps": 1, "save_steps": 0, "val_sets": ["synthetic-asr"],
        "val_steps": 1, "val_num_samples": 1, "report_logs_to": []}) + ["--device", "cpu"]
    with pytest.raises(RuntimeError) as err:
        start("train", dict(argv=argv), str(tmp_path / "run"), world=2, timeout=120).result()
    logs = str(err.value).split("--- rank ")[1:]
    assert "return codes [1, 1]" in str(err.value) and len(logs) == 2
    for log in logs:
        assert "ValueError: val set synthetic-asr has fewer samples than the 2 processes" in log
