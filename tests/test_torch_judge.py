"""The port's GPT judge (``evaluation/gpt_eval.py``), its retry helpers
(``utils/retry.py``) and the judge metrics' wiring (``metrics.
evaluate_answers``, ``voicebench.voicebench_open``) against the JAX
package's, on the CPU.

- ``retry``: the same backoff delays (``time.sleep`` and
  ``random.uniform`` patched), the same final raise, no retry of an
  exception outside ``retry_on``; ``safe_audio_decode``.
- ``JUDGE_PROMPTS`` equal; the three parsers equal on hypothesis-made
  strings.
- Each of the six judge metrics and ``voicebench_open`` with the same
  recording fake client on both sides: the same requests (messages, model,
  ``max_tokens``, temperature) and the same ``EvalResult`` s; a client
  that raises gives -1 on both; without a client, ``openai`` is imported
  at the first request.
- The port's eval CLI scores a set whose metric is ``boolq`` from a
  config, with a fake judge.
- Phase 17 (e) and (f) of chip_smoke.py against the port's own HTTP
  server on tests/assets/tiny_ultravox (CPU, fp32), through its urllib
  client: each judge result is the parser applied to the server's reply;
  ds_tool's textgen through ``DatasetChunkProcessor``, then from its disk
  cache with no request and the same column.
"""

import json
import random
import shutil
import sys
import time
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.helpers import make_tiny_tokenizer
from ultravox_torch.evaluation import gpt_eval as tgpt
from ultravox_torch.evaluation import metrics as tmetrics
from ultravox_torch.evaluation import voicebench as tvb  # noqa: F401  (registers its metrics)
from ultravox_torch.utils import retry as tretry
from ultravox_tpu.evaluation import gpt_eval as jgpt
from ultravox_tpu.evaluation import metrics as jmetrics
from ultravox_tpu.evaluation import voicebench as jvb  # noqa: F401
from ultravox_tpu.utils import retry as jretry

FIXTURE = "tests/assets/tiny_ultravox"
JUDGE_METRICS = sorted(jgpt.JUDGE_PROMPTS)


@pytest.fixture(autouse=True)
def judge_clients():
    """Both registries hold the judge metrics (as after a first judge
    request in each package), and both singletons' clients are restored."""
    tmetrics._register_gpt_metrics()
    jmetrics._register_gpt_metrics()
    saved = tgpt.gpt_evaluator.client, jgpt.gpt_evaluator.client
    yield
    tgpt.gpt_evaluator.client, jgpt.gpt_evaluator.client = saved


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


def _retried(mod, monkeypatch, fails: int, exc=ValueError, **kw):
    """(outcome, sleeps, calls) of a function that raises ``fails`` times
    under ``mod.retry(**kw)``; the jitter is a seeded draw."""
    rng = np.random.default_rng(7)
    sleeps, calls = [], []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    monkeypatch.setattr(random, "uniform", lambda a, b: a + (b - a) * float(rng.random()))

    @mod.retry(**kw)
    def flaky(x):
        calls.append(x)
        if len(calls) <= fails:
            raise exc(f"attempt {len(calls)}")
        return x * 2

    try:
        outcome = ("ok", flaky(21))
    except Exception as e:  # noqa: BLE001
        outcome = ("raised", type(e).__name__, str(e))
    return outcome, sleeps, calls


@pytest.mark.parametrize("fails, kw", [
    (0, {}),
    (2, {}),
    (4, {}),
    (5, {}),
    (3, dict(max_attempts=4, base_delay_s=2.0, max_delay_s=5.0)),
    (6, dict(max_attempts=3, base_delay_s=0.5)),
    (1, dict(max_attempts=1)),
    (2, dict(retry_on=(KeyError,))),
])
def test_retry_matches_jax(monkeypatch, fails, kw):
    got = _retried(tretry, monkeypatch, fails, **kw)
    want = _retried(jretry, monkeypatch, fails, **kw)
    assert got == want
    outcome, sleeps, calls = got
    attempts = kw.get("max_attempts", 5)
    if "retry_on" in kw:  # a ValueError is not retried
        assert outcome[0] == "raised" and sleeps == [] and len(calls) == 1
    elif fails < attempts:
        assert outcome == ("ok", 42) and len(sleeps) == fails
    else:
        assert outcome == ("raised", "ValueError", f"attempt {attempts}")
        assert len(sleeps) == attempts - 1
    base, cap = kw.get("base_delay_s", 1.0), kw.get("max_delay_s", 30.0)
    for a, d in enumerate(sleeps):
        assert 0.5 * min(base * 2**a, cap) <= d <= 1.5 * min(base * 2**a, cap)


def test_safe_audio_decode_matches_jax():
    def bad():
        raise OSError("truncated")

    for mod in (tretry, jretry):
        assert mod.safe_audio_decode(bad) is None
        assert mod.safe_audio_decode(lambda a, b=1: a + b, 2, b=3) == 5


# ---------------------------------------------------------------------------
# prompts and parsers
# ---------------------------------------------------------------------------


def test_judge_prompts_equal():
    assert tgpt.JUDGE_PROMPTS == jgpt.JUDGE_PROMPTS
    assert tgpt.RATING_MODEL == jgpt.RATING_MODEL
    assert tgpt.gpt_evaluator.model == jgpt.gpt_evaluator.model
    assert sorted(tgpt._PARSERS) == sorted(jgpt._PARSERS)


WORDS = st.sampled_from(["true", "False", "TRUE", "falsey", "yes", "No", "nope", "Rating:",
                         "rating 3", "4/5", "/ 5", "3.5", "10", "0.", ".7", "x", "-2",
                         "untrue", "Yes!", "\n", "\t", " ", "é", "5 / 5"])
REPLIES = st.one_of(st.text(max_size=40), st.lists(WORDS | st.text(max_size=4),
                                                   max_size=8).map(" ".join))


@pytest.mark.parametrize("parser", ["parse_binary", "parse_scalar", "parse_yes_no"])
@settings(max_examples=150, deadline=None)
@given(text=REPLIES)
def test_parsers_match_jax(parser, text):
    got, want = getattr(tgpt, parser)(text), getattr(jgpt, parser)(text)
    assert (got.score, got.reason) == (want.score, want.reason)


# ---------------------------------------------------------------------------
# the judge metrics with a recording fake client
# ---------------------------------------------------------------------------

FAKE_REPLIES = ["True, the agent followed it.", "false", "Rating: 4 - good", "3/5 okay",
                "I cannot tell", "Yes", "TRUE", "Rating: 2.5", ""]


class FakeClient:
    """``chat.completions.create`` that records each request and answers
    with a reply picked by the request's content (the same on both sides,
    whatever the order of the threads); ``fail`` raises instead."""

    def __init__(self, fail=None):
        self.sent = []
        self.fail = fail
        self.chat = types.SimpleNamespace(completions=types.SimpleNamespace(create=self.create))

    def create(self, **kw):
        self.sent.append(kw)
        if self.fail is not None:
            raise self.fail
        key = sum(json.dumps(kw, sort_keys=True).encode())
        content = FAKE_REPLIES[key % len(FAKE_REPLIES)]
        message = types.SimpleNamespace(content=content)
        return types.SimpleNamespace(choices=[types.SimpleNamespace(message=message)])


def _judge_samples(mod, seed: int, n: int = 6):
    """Samples from numpy draws of words, with histories for some."""
    rng = np.random.default_rng(seed)
    vocab = ["paris", "is", "the", "capital", "true", "false", "of", "france", "yes", "a",
             "<b>", "{{ x }}", "café", "42"]
    words = lambda k: " ".join(rng.choice(vocab, size=k))  # noqa: E731
    out = []
    for i in range(n):
        history = ([{"role": "user", "content": words(3)},
                    {"role": "assistant", "content": words(4)}] if i % 2 else None)
        out.append(mod.EvalSample(i, words(5), words(2), words(6),
                                  transcript=words(3) if i % 3 else None, history=history))
    return out


def _score(mod, gpt, metric, client, seed, args=None):
    gpt.gpt_evaluator.client = client
    result = mod.evaluate_answers(_judge_samples(mod, seed), metric, args)
    sent = sorted(json.dumps(kw, sort_keys=True) for kw in client.sent)
    return result["score"], [(r.score, r.reason) for r in result["per_sample"]], sent


@pytest.mark.parametrize("metric", JUDGE_METRICS + ["voicebench_open"])
@pytest.mark.parametrize("seed", [0, 1])
def test_judge_metrics_match_jax(metric, seed):
    got = _score(tmetrics, tgpt, metric, FakeClient(), seed)
    want = _score(jmetrics, jgpt, metric, FakeClient(), seed)
    assert got == want
    assert len(got[2]) == 6
    for body in map(json.loads, got[2]):
        assert body["model"] == jgpt.gpt_evaluator.model
        assert body["max_tokens"] == 256 and body["temperature"] == 0.0
        assert [m["role"] for m in body["messages"]] == ["system", "user"]
    parser = tgpt._PARSERS[tgpt.JUDGE_PROMPTS[metric]["parser"]] if metric in JUDGE_METRICS \
        else tgpt.parse_scalar
    assert {s for s, _ in got[1]} <= {s for r in FAKE_REPLIES for s in [parser(r).score]}


@pytest.mark.parametrize("metric", JUDGE_METRICS + ["voicebench_open"])
def test_judge_metric_args_reach_the_template(metric):
    """Extra metric args are rendered (or ignored) alike."""
    got = _score(tmetrics, tgpt, metric, FakeClient(), 3, {"lang": "en"})
    want = _score(jmetrics, jgpt, metric, FakeClient(), 3, {"lang": "en"})
    assert got == want


@pytest.mark.parametrize("metric", JUDGE_METRICS + ["voicebench_open"])
def test_a_failing_judge_scores_minus_one(metric):
    got = _score(tmetrics, tgpt, metric, FakeClient(RuntimeError("endpoint down")), 0)
    want = _score(jmetrics, jgpt, metric, FakeClient(RuntimeError("endpoint down")), 0)
    assert got == want
    assert got[1] == [(-1.0, "endpoint down")] * 6 and got[0] == 0.0


def test_the_judge_imports_openai_at_its_first_request(monkeypatch):
    """Without a client, ``ask`` builds ``openai.OpenAI()`` (a fake module
    here); with ``openai`` missing, every sample scores -1 on both sides."""
    built = []

    def OpenAI():
        built.append(FakeClient())
        return built[-1]

    monkeypatch.setitem(sys.modules, "openai", types.SimpleNamespace(OpenAI=OpenAI))
    for gpt in (tgpt, jgpt):
        judge = gpt.GPTBasedEvaluator()
        assert judge.ask("sys", "user", max_tokens=7) == judge.ask("sys", "user", max_tokens=7)
    assert len(built) == 2 and [len(c.sent) for c in built] == [2, 2]
    assert built[0].sent == built[1].sent

    monkeypatch.setitem(sys.modules, "openai", None)
    tgpt.gpt_evaluator.client = jgpt.gpt_evaluator.client = None
    got = tmetrics.evaluate_answers(_judge_samples(tmetrics, 0), "instruct")
    want = jmetrics.evaluate_answers(_judge_samples(jmetrics, 0), "instruct")
    assert [(r.score, r.reason) for r in got["per_sample"]] == [
        (r.score, r.reason) for r in want["per_sample"]]
    assert all(r.score == -1.0 for r in got["per_sample"])


def test_registries_hold_the_judge_metrics():
    assert sorted(tmetrics.METRIC_REGISTRY) == sorted(jmetrics.METRIC_REGISTRY)
    assert set(JUDGE_METRICS) <= set(tmetrics.METRIC_REGISTRY)
    with pytest.raises(KeyError, match="unknown metric"):
        tmetrics.evaluate_answers(_judge_samples(tmetrics, 0), "no_such_judge")


# ---------------------------------------------------------------------------
# the eval CLI and the port's own server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt")
    for name in ("config.json", "model.safetensors"):
        shutil.copy(f"{FIXTURE}/{name}", out / name)
    make_tiny_tokenizer().save_pretrained(out)
    return str(out)


def test_eval_cli_scores_boolq_with_a_fake_judge(ckpt, tmp_path, monkeypatch):
    """``python -m ultravox_torch.evaluation.eval --config_path <yaml>`` on a
    set scored by the ``boolq`` judge (synthetic-asr's rows): the summary's
    score is the mean of the parsed replies, and the judge was asked what
    the JAX package's ``boolq`` metric asks of the same samples."""
    import yaml

    from ultravox_torch.data import registry, types as dtypes
    from ultravox_torch.data.datasets import SyntheticAsrDataset
    from ultravox_torch.evaluation import eval as teval

    name = "judge-boolq-synthetic"
    registry.register_datasets([dtypes.DatasetConfig(
        name=name, eval_config=dtypes.EvalConfig(metric="boolq"))])
    create = registry.create_dataset
    monkeypatch.setattr(registry, "create_dataset", lambda n, args: SyntheticAsrDataset(args)
                        if n == name else create(n, args))
    out = tmp_path / "out"
    cfg = tmp_path / "eval.yaml"
    cfg.write_text(yaml.safe_dump(dict(model=ckpt, eval_sets=[name], num_samples=3,
                                       batch_size=2, max_tokens=4, device="cpu",
                                       output_dir=str(out))))
    client = FakeClient()
    tgpt.gpt_evaluator.client = client
    monkeypatch.setattr(sys, "argv", ["eval", "--config_path", str(cfg)])
    try:
        teval.main()
    finally:
        registry.unregister_datasets([name])
    with open(out / "summary.json") as f:
        summary = json.load(f)
    with open(out / f"{name}.json") as f:
        samples = json.load(f)["samples"]
    assert summary[name]["metric"] == "boolq" and summary[name]["num_samples"] == 3

    jclient = FakeClient()
    jgpt.gpt_evaluator.client = jclient
    want = jmetrics.evaluate_answers([jmetrics.EvalSample(**s) for s in samples], "boolq")
    assert summary[name]["score"] == want["score"]
    assert sorted(map(json.dumps, client.sent)) == sorted(map(json.dumps, jclient.sent))
    assert len(client.sent) == 3


def test_judge_and_textgen_against_the_ports_own_server(ckpt, tmp_path, monkeypatch):
    """Phase 17 (e) and (f) of chip_smoke.py on the CPU: the tiny checkpoint
    served by ``run_serving_eval.start_server`` answers the port's judge
    (boolq, audiobench_scalar, voicebench_open; each result the parser
    applied to the reply ``_ChatClient`` kept) and ds_tool's textgen through
    ``DatasetChunkProcessor`` (6 rows in chunks of 4, then again from the
    disk cache: no request, no prefill, the same column). Two judge samples
    a metric here, four on the card."""
    import chip_smoke
    from ultravox_torch.inference import run_serving_eval as trse

    monkeypatch.setattr(chip_smoke, "JUDGE_SAMPLES", 2)
    answers = ["the cat sat", "", "paris is the capital"]
    server, engine, port = trse.start_server(ckpt, num_slots=4, max_seq_len=512, device="cpu")
    try:
        trse.wait_healthy(port)
        client, results, _ = chip_smoke._judge_run(port, answers)
        rows = [f"Row {i}: {answers[i % 3]}" for i in range(chip_smoke.TEXTGEN_ROWS)]
        split, task = chip_smoke._textgen_task(client, str(tmp_path), rows)
        first = chip_smoke._textgen_pass(split, task, client, str(tmp_path / "first"),
                                         len(rows))
        chunks = engine.stat_prefill_chunks
        cached = chip_smoke._textgen_pass(split, task, client, str(tmp_path / "cached"), 0,
                                          first)
        assert engine.stat_prefill_chunks == chunks
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    n = len(chip_smoke.JUDGE_SET) * chip_smoke.JUDGE_SAMPLES
    assert client.requests == len(client.replies) == n + len(rows)
    assert sorted(results) == sorted(m for m, _ in chip_smoke.JUDGE_SET)
    assert all(len(r["per_sample"]) == chip_smoke.JUDGE_SAMPLES for r in results.values())
    assert cached["column"] == first["column"] and len(first["column"]) == len(rows)
    assert [r for _, r in client.replies[n:]] == first["column"]
