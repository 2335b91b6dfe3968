"""GPT-judge evaluation through an OpenAI-compatible chat endpoint.

A singleton judge (``gpt_evaluator``) with Jinja2 user prompts, three
answer parsers (binary with a reason, a scalar rating, yes/no) and the
judge templates of the instruct / conversation / boolq / bigbench /
audiobench tasks, the same templates character for character as the JAX
package's, so both ask a judge the same question. The client is any
object with ``chat.completions.create`` (the ``openai`` SDK's, imported
only when no client was set, or a plain HTTP one): the port's own server
answers that protocol, and tests inject a fake.

The judge's model is ``GPT_EVAL_MODEL`` (``gpt-4o`` by default); a client
built here takes its endpoint from the ``openai`` SDK's environment
(``OPENAI_BASE_URL``, ``OPENAI_API_KEY``).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict

from ultravox_torch.evaluation.metrics import EvalResult, EvalSample

logger = logging.getLogger(__name__)

RATING_MODEL = "gpt-4o"

JUDGE_PROMPTS: Dict[str, Dict[str, str]] = {
    "instruct": {
        "system": (
            "You are an expert evaluator. Decide whether the agent followed "
            "the user's instruction. Respond with 'True' or 'False' followed "
            "by a short justification."
        ),
        "user": (
            "Instruction: {{ question }}\n\nAgent response: {{ generated_answer }}"
            "\n\nDid the agent follow the instruction?"
        ),
        "parser": "binary",
    },
    "conversation": {
        "system": (
            "You are an expert evaluator of voice assistants. Given the "
            "conversation history and the latest user turn, decide if the "
            "agent's response is appropriate and helpful. Respond with "
            "'True' or 'False' and a short justification."
        ),
        "user": (
            "{% if history %}History:\n{% for m in history %}{{ m.role }}: "
            "{{ m.content }}\n{% endfor %}\n{% endif %}"
            "User: {{ question }}\nAgent: {{ generated_answer }}\n\n"
            "Is the agent response appropriate?"
        ),
        "parser": "binary",
    },
    "boolq": {
        "system": (
            "Compare the agent's answer to the expected true/false answer. "
            "Respond 'True' if they agree, otherwise 'False'."
        ),
        "user": (
            "Expected: {{ expected_answer }}\nAgent: {{ generated_answer }}"
        ),
        "parser": "binary",
    },
    "bigbench": {
        "system": (
            "Decide whether the model answer matches the reference answer "
            "for this reasoning task. Respond 'True' or 'False'."
        ),
        "user": (
            "Question: {{ question }}\nReference: {{ expected_answer }}\n"
            "Model: {{ generated_answer }}"
        ),
        "parser": "binary",
    },
    "audiobench_binary": {
        "system": (
            "Judge the model response against the reference. Respond 'True' "
            "if acceptable, else 'False'."
        ),
        "user": (
            "Question: {{ question }}\nReference: {{ expected_answer }}\n"
            "Response: {{ generated_answer }}"
        ),
        "parser": "binary",
    },
    "audiobench_scalar": {
        "system": (
            "Rate the model response against the reference on a 0-5 scale. "
            "Respond with 'Rating: <n>' and a justification."
        ),
        "user": (
            "Question: {{ question }}\nReference: {{ expected_answer }}\n"
            "Response: {{ generated_answer }}"
        ),
        "parser": "scalar",
    },
}


def parse_binary(text: str) -> EvalResult:
    """1.0 for the first "true", 0.0 for the first "false", -1 for neither."""
    m = re.search(r"\b(true|false)\b", text, re.IGNORECASE)
    if not m:
        return EvalResult(score=-1.0, reason=f"unparseable: {text[:200]}")
    return EvalResult(score=1.0 if m.group(1).lower() == "true" else 0.0, reason=text.strip())


def parse_scalar(text: str, scale: float = 5.0) -> EvalResult:
    """The first number in the text (after an optional "Rating:") over ``scale``."""
    m = re.search(r"(?:rating[:\s]*)?(\d+(?:\.\d+)?)\s*(?:/\s*5)?", text, re.IGNORECASE)
    if not m:
        return EvalResult(score=-1.0, reason=f"unparseable: {text[:200]}")
    return EvalResult(score=float(m.group(1)) / scale, reason=text.strip())


def parse_yes_no(text: str) -> EvalResult:
    m = re.search(r"\b(yes|no)\b", text, re.IGNORECASE)
    if not m:
        return EvalResult(score=-1.0, reason=f"unparseable: {text[:200]}")
    return EvalResult(score=float(m.group(1).lower() == "yes"), reason=text.strip())


class GPTBasedEvaluator:
    """The judge client. ``client`` is any object with
    ``chat.completions.create`` (OpenAI SDK compatible); left None, the
    first ``ask`` builds ``openai.OpenAI()``."""

    def __init__(self):
        self.client: Any = None
        self.model = os.environ.get("GPT_EVAL_MODEL", RATING_MODEL)

    def _ensure_client(self):
        if self.client is None:
            import openai  # optional dependency

            self.client = openai.OpenAI()
        return self.client

    def ask(self, system: str, user: str, max_tokens: int = 256) -> str:
        client = self._ensure_client()
        response = client.chat.completions.create(
            model=self.model,
            messages=[
                {"role": "system", "content": system},
                {"role": "user", "content": user},
            ],
            max_tokens=max_tokens,
            temperature=0.0,
        )
        return response.choices[0].message.content or ""


gpt_evaluator = GPTBasedEvaluator()

_PARSERS = {"binary": parse_binary, "scalar": parse_scalar, "yes_no": parse_yes_no}


def make_judge_metric(name: str):
    """The sample metric of ``JUDGE_PROMPTS[name]``: render the user
    prompt, ask ``gpt_evaluator``, parse the reply (-1 when the endpoint
    fails)."""
    import jinja2

    spec = JUDGE_PROMPTS[name]
    parser = _PARSERS[spec["parser"]]
    user_template = jinja2.Template(spec["user"])

    def metric(sample: EvalSample, args: Dict[str, Any]) -> EvalResult:
        user = user_template.render(
            question=sample.question,
            expected_answer=sample.expected_answer,
            generated_answer=sample.generated_answer,
            transcript=sample.transcript,
            history=sample.history,
            **args,
        )
        try:
            text = gpt_evaluator.ask(spec["system"], user)
        except Exception as e:  # endpoint unavailable
            logger.warning("gpt judge %s failed: %s", name, e)
            return EvalResult(score=-1.0, reason=str(e))
        return parser(text)

    return metric
