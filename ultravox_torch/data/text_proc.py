"""Text processing for dataset templates and ASR cleanup.

Re-design of the reference's ``data/text_proc.py``: Jinja2 template rendering
with ``text_proc`` in scope, Gigaspeech punctuation-tag conversion, and
garbage-utterance rejection.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional


class TemplateError(ValueError):
    pass


GIGASPEECH_TAGS = {
    "<COMMA>": ",",
    "<PERIOD>": ".",
    "<QUESTIONMARK>": "?",
    "<EXCLAMATIONPOINT>": "!",
}
GIGASPEECH_GARBAGE = ["<SIL>", "<NOISE>", "<VOCALIZED_NOISE>", "<OTHER>"]


def format_asr_text(text: str) -> str:
    """Convert Gigaspeech-style tags to punctuation and reject garbage
    utterances (reference: text_proc.py:25-50)."""
    remaining = text
    for tag, punct in GIGASPEECH_TAGS.items():
        remaining = remaining.replace(f" {tag}", punct).replace(tag, punct)
    for garbage in GIGASPEECH_GARBAGE:
        if garbage in remaining:
            raise TemplateError(f"garbage utterance: {text!r}")
    text = remaining.strip()
    if not text:
        raise TemplateError("empty utterance")
    return _lower_with_sentence_case(text)


def _lower_with_sentence_case(text: str) -> str:
    """Approximate truecasing: lowercase, then capitalise sentence starts and
    the pronoun I (replaces the reference's `truecase` dependency with a
    deterministic rule)."""
    if not text.isupper():
        return text
    text = text.lower()
    text = re.sub(r"(^|[.!?]\s+)([a-z])", lambda m: m.group(1) + m.group(2).upper(), text)
    text = re.sub(r"\bi\b", "I", text)
    return text


def format_message_history(messages, add_generation_prompt: bool = True) -> str:
    parts = []
    for m in messages:
        parts.append(f"{m['role']}: {m['content']}")
    return "\n".join(parts)


_TEMPLATE_ENV = None


def _env():
    global _TEMPLATE_ENV
    if _TEMPLATE_ENV is None:
        import jinja2

        _TEMPLATE_ENV = jinja2.Environment(undefined=jinja2.StrictUndefined)
    return _TEMPLATE_ENV


def render_template(
    template: str,
    row: Dict[str, Any],
    template_args: Optional[Dict[str, str]] = None,
    language: Optional[str] = None,
) -> str:
    """Render a Jinja2 template with the dataset row and ``text_proc`` helpers
    in scope (reference: datasets.py:354-468)."""
    import sys

    ctx: Dict[str, Any] = dict(row)
    ctx["text_proc"] = sys.modules[__name__]
    if template_args:
        ctx.update(template_args)
    if language is not None:
        ctx["language"] = language
    try:
        return _env().from_string(template).render(**ctx)
    except TemplateError:
        raise
    except Exception as e:
        raise TemplateError(f"template {template!r} failed: {e}") from e
