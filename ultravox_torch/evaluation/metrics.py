"""Metric registries (reference: evaluation/eval_metrics.py:16-63).

Two kinds:
- corpus metrics (``CORPUS_METRIC_REGISTRY``): (references, hypotheses, args)
  -> score — wer/cer/bleu;
- sample metrics (``METRIC_REGISTRY``): one score per (expected, generated)
  pair, fanned out over a thread pool, then mean-aggregated.

The GPT-judge metrics (``gpt_eval.JUDGE_PROMPTS``) register on the first
request for a metric not yet registered; they ask an OpenAI-compatible
endpoint at scoring time.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ultravox_torch.evaluation import string_metrics


@dataclasses.dataclass
class EvalSample:
    index: int
    question: str
    expected_answer: str
    generated_answer: str
    transcript: Optional[str] = None
    history: Optional[List[Dict[str, str]]] = None


@dataclasses.dataclass
class EvalResult:
    score: float
    reason: Optional[str] = None


SampleMetric = Callable[[EvalSample, Dict[str, Any]], EvalResult]
CorpusMetric = Callable[[List[EvalSample], Dict[str, Any]], float]


def _wrap_pair(fn):
    def metric(sample: EvalSample, args: Dict[str, Any]) -> EvalResult:
        return EvalResult(fn(sample.expected_answer, sample.generated_answer))

    return metric


METRIC_REGISTRY: Dict[str, SampleMetric] = {
    "exact_match": _wrap_pair(string_metrics.exact_match),
    "exact_match_last_word": _wrap_pair(string_metrics.exact_match_last_word),
    "partial_match": _wrap_pair(string_metrics.partial_match),
}


def _corpus_wer(samples, args):
    return string_metrics.wer(
        [s.expected_answer for s in samples],
        [s.generated_answer for s in samples],
        language=args.get("lang_id", "en"),
    )


def _corpus_cer(samples, args):
    return string_metrics.cer(
        [s.expected_answer for s in samples],
        [s.generated_answer for s in samples],
    )


def _corpus_bleu(samples, args):
    return string_metrics.bleu(
        [s.expected_answer for s in samples],
        [s.generated_answer for s in samples],
        language=args.get("lang_id", "en"),
    )


CORPUS_METRIC_REGISTRY: Dict[str, CorpusMetric] = {
    "wer": _corpus_wer,
    "cer": _corpus_cer,
    "bleu": _corpus_bleu,
}


def register_sample_metric(name: str, fn: SampleMetric) -> None:
    METRIC_REGISTRY[name] = fn


def register_corpus_metric(name: str, fn: CorpusMetric) -> None:
    CORPUS_METRIC_REGISTRY[name] = fn


def _register_gpt_metrics():
    """The GPT-judge metrics, registered lazily (they need an
    OpenAI-compatible endpoint at eval time)."""
    from ultravox_torch.evaluation import gpt_eval

    for name in gpt_eval.JUDGE_PROMPTS:
        METRIC_REGISTRY[name] = gpt_eval.make_judge_metric(name)


def evaluate_answers(
    samples: List[EvalSample],
    metric: str,
    metric_args: Optional[Dict[str, Any]] = None,
    max_workers: int = 8,
) -> Dict[str, Any]:
    """Score a result set (reference: eval_metrics.py:48-63). Returns
    {"score": float, "per_sample": [...] | None}."""
    metric_args = metric_args or {}
    if metric in CORPUS_METRIC_REGISTRY:
        return {
            "score": CORPUS_METRIC_REGISTRY[metric](samples, metric_args),
            "per_sample": None,
        }
    if metric not in METRIC_REGISTRY:
        _register_gpt_metrics()
    if metric not in METRIC_REGISTRY:
        raise KeyError(f"unknown metric {metric!r}")
    fn = METRIC_REGISTRY[metric]
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(lambda s: fn(s, metric_args), samples))
    scores = [r.score for r in results if r.score >= 0]
    return {
        "score": sum(scores) / max(len(scores), 1),
        "per_sample": results,
    }
