"""IFEval — instruction-following evaluation.

Re-implementation of the instruction-checker battery the reference vendors
from Google (evaluation/ifeval/, ~3.4K LoC; paper: arXiv:2311.07911). Each
sample carries ``instruction_id_list`` + per-instruction kwargs; a response
passes an instruction iff its checker accepts. Scoring follows the strict /
loose protocol: loose retries with line-stripped and asterisk-stripped
response variants.

The checkers cover the instruction families IFEval uses: keywords, length
constraints, detectable content/format, combination, start/end, case, and
punctuation.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, List

Checker = Callable[[str, Dict[str, Any]], bool]


def _words(text: str) -> List[str]:
    return re.findall(r"\w+", text)


def _sentences(text: str) -> List[str]:
    parts = re.split(r"[.!?]+(?:\s|$)", text)
    return [p for p in parts if p.strip()]


def _paragraphs(text: str) -> List[str]:
    return [p for p in re.split(r"\n\s*\n|\s*\*\*\*\s*", text) if p.strip()]


def _rel(count: int, relation: str, target: int) -> bool:
    if relation == "at least":
        return count >= target
    if relation == "at most":
        return count <= target
    if relation in ("exactly", None, "equal to"):
        return count == target
    return count >= target


# -- keywords -------------------------------------------------------------


def keywords_existence(text: str, kw) -> bool:
    return all(
        re.search(rf"\b{re.escape(k)}\b", text, re.IGNORECASE)
        for k in kw.get("keywords", [])
    )


def keywords_frequency(text: str, kw) -> bool:
    count = len(
        re.findall(rf"\b{re.escape(kw['keyword'])}\b", text, re.IGNORECASE)
    )
    return _rel(count, kw.get("relation", "at least"), kw.get("frequency", 1))


def keywords_forbidden(text: str, kw) -> bool:
    return not any(
        re.search(rf"\b{re.escape(k)}\b", text, re.IGNORECASE)
        for k in kw.get("forbidden_words", [])
    )


def letter_frequency(text: str, kw) -> bool:
    count = text.lower().count(kw["letter"].lower())
    return _rel(count, kw.get("let_relation", "at least"), kw.get("let_frequency", 1))


# -- length constraints ------------------------------------------------------


def number_words(text: str, kw) -> bool:
    return _rel(
        len(_words(text)), kw.get("relation", "at least"), kw.get("num_words", 1)
    )


def number_sentences(text: str, kw) -> bool:
    return _rel(
        len(_sentences(text)),
        kw.get("relation", "at least"),
        kw.get("num_sentences", 1),
    )


def number_paragraphs(text: str, kw) -> bool:
    return len(_paragraphs(text)) == kw.get("num_paragraphs", 1)


def nth_paragraph_first_word(text: str, kw) -> bool:
    paras = [p for p in text.split("\n\n") if p.strip()]
    if len(paras) != kw.get("num_paragraphs", len(paras)):
        return False
    n = kw.get("nth_paragraph", 1)
    if n > len(paras):
        return False
    first = _words(paras[n - 1])
    return bool(first) and first[0].lower() == kw["first_word"].lower()


# -- detectable content ----------------------------------------------------


def number_placeholders(text: str, kw) -> bool:
    return len(re.findall(r"\[.*?\]", text)) >= kw.get("num_placeholders", 1)


def postscript(text: str, kw) -> bool:
    marker = kw.get("postscript_marker", "P.S.")
    pattern = (
        r"\bp\.\s?s\.?" if marker.upper().startswith("P.S") else re.escape(marker)
    )
    return bool(re.search(pattern, text, re.IGNORECASE))


# -- detectable format -----------------------------------------------------


def number_bullet_lists(text: str, kw) -> bool:
    bullets = re.findall(r"^\s*[\*\-]\s", text, re.MULTILINE)
    return len(bullets) == kw.get("num_bullets", 1)


def constrained_response(text: str, kw) -> bool:
    options = kw.get(
        "options",
        ("My answer is yes.", "My answer is no.", "My answer is maybe."),
    )
    return any(opt.lower() in text.lower() for opt in options)


def number_highlighted_sections(text: str, kw) -> bool:
    return len(re.findall(r"\*[^\n\*]+\*", text)) >= kw.get("num_highlights", 1)


def multiple_sections(text: str, kw) -> bool:
    splitter = kw.get("section_spliter", kw.get("section_splitter", "Section"))
    found = re.findall(
        rf"{re.escape(splitter)}\s+\d", text, re.IGNORECASE
    )
    return len(found) >= kw.get("num_sections", 1)


def json_format(text: str, kw) -> bool:
    stripped = (
        text.strip().removeprefix("```json").removeprefix("```").removesuffix("```")
    ).strip()
    try:
        json.loads(stripped)
        return True
    except ValueError:
        return False


def title(text: str, kw) -> bool:
    return bool(re.search(r"<<[^\n]+>>", text))


# -- combination -----------------------------------------------------------


def repeat_prompt(text: str, kw) -> bool:
    return text.strip().lower().startswith(
        kw.get("prompt_to_repeat", "").strip().lower()
    )


def two_responses(text: str, kw) -> bool:
    parts = text.split("******")
    valid = [p for p in parts if p.strip()]
    return len(valid) == 2 and valid[0].strip() != valid[1].strip()


# -- start / end -------------------------------------------------------------


def end_checker(text: str, kw) -> bool:
    return text.strip().lower().endswith(kw.get("end_phrase", "").strip().lower())


def quotation(text: str, kw) -> bool:
    t = text.strip()
    return t.startswith('"') and t.endswith('"')


# -- case --------------------------------------------------------------------


def capital_word_frequency(text: str, kw) -> bool:
    count = sum(1 for w in _words(text) if w.isupper())
    return _rel(
        count,
        kw.get("capital_relation", "at least"),
        kw.get("capital_frequency", 1),
    )


def english_capital(text: str, kw) -> bool:
    letters = [c for c in text if c.isalpha()]
    return bool(letters) and all(c.isupper() for c in letters)


def english_lowercase(text: str, kw) -> bool:
    letters = [c for c in text if c.isalpha()]
    return bool(letters) and all(c.islower() for c in letters)


# -- punctuation ----------------------------------------------------------------


def no_comma(text: str, kw) -> bool:
    return "," not in text


# -- language ---------------------------------------------------------------

_STOPWORDS = {
    "en": {"the", "and", "is", "of", "to", "in", "that", "it", "you", "for"},
    "de": {"der", "die", "das", "und", "ist", "nicht", "ich", "ein", "zu", "mit"},
    "fr": {"le", "la", "les", "est", "et", "je", "vous", "pour", "dans", "une"},
    "es": {"el", "la", "los", "es", "y", "que", "una", "para", "con", "por"},
    "it": {"il", "la", "che", "è", "e", "per", "una", "sono", "con", "non"},
    "pt": {"o", "a", "que", "é", "e", "para", "uma", "com", "não", "os"},
}
_SCRIPTS = [
    ("zh", r"[一-鿿]"), ("ja", r"[぀-ヿ]"),
    ("ko", r"[가-힯]"), ("ru", r"[Ѐ-ӿ]"),
    ("ar", r"[؀-ۿ]"), ("hi", r"[ऀ-ॿ]"),
    ("th", r"[฀-๿]"), ("he", r"[֐-׿]"),
]


def _detect_language(text: str):
    try:
        import langdetect

        return langdetect.detect(text)
    except Exception:  # noqa: BLE001 — package absent or detection failure
        pass
    chars = [c for c in text if not c.isspace()]
    if not chars:
        return None
    for lang, pattern in _SCRIPTS:
        if len(re.findall(pattern, text)) / len(chars) > 0.3:
            return lang
    words = set(w.lower() for w in re.findall(r"[a-zA-Zà-ÿ]+", text))
    best, best_hits = None, 0
    for lang, stops in _STOPWORDS.items():
        hits = len(words & stops)
        if hits > best_hits:
            best, best_hits = lang, hits
    return best if best_hits >= 2 else "en" if words else None


def response_language(text: str, kw) -> bool:
    """reference: ifeval ResponseLanguageChecker (langdetect); heuristic
    script/stopword fallback when langdetect is unavailable."""
    detected = _detect_language(text)
    target = kw.get("language", "en")
    return detected is not None and detected.startswith(target.split("-")[0])


# -- dormant-in-reference instruction families ----------------------------
# The reference registry keeps these four commented out
# (evaluation/ifeval/instructions_registry.py:43-64) though the checker
# classes exist (instructions.py:386,671,1053,1153); the IFEval dataset
# never emits them. Implemented here for registry completeness.


def key_sentences(text: str, kw) -> bool:
    """reference: ifeval KeySentenceChecker — exactly ``num_sentences`` of
    the given sentences must appear in the response.

    DELIBERATE divergence from the reference semantics (ADVICE r4 #4): the
    reference counts exact string membership of each key sentence in its
    ``split_into_sentences`` output, which makes the check fail on trailing
    punctuation or whitespace differences introduced by its own splitter.
    This checker normalizes whitespace/case and strips terminal punctuation
    on BOTH sides before membership, so scores on this (dormant — the
    IFEval dataset never emits it) instruction are slightly more lenient
    than the reference's and not comparable to reference-published numbers.
    """

    def norm(s: str) -> str:
        return re.sub(r"\s+", " ", s).strip().rstrip(".!?").lower()

    have = {norm(s) for s in _sentences(text)}
    count = sum(
        1 for s in kw.get("key_sentences", []) if norm(s) in have
    )
    return count == kw.get("num_sentences", 1)


def rephrase(text: str, kw) -> bool:
    """reference: ifeval RephraseChecker — the response may differ from
    ``original_message`` only inside *asterisk-marked* spans."""
    original = kw.get("original_message", "")
    if not re.search(r"\*.*\*", text) or not re.search(r"\*.*\*", original):
        return False
    strip = lambda s: re.sub(r"\*.*\*", "", s)  # noqa: E731
    return strip(text) == strip(original)


def rephrase_paragraph(text: str, kw) -> bool:
    """reference: ifeval RephraseParagraph — between ``low`` and ``high``
    words in common with ``original_paragraph`` (case-insensitive,
    multiset intersection)."""
    import collections

    val = collections.Counter(_words(text.lower()))
    orig = collections.Counter(
        _words(kw.get("original_paragraph", "").lower())
    )
    similar = sum(min(orig[w], val[w]) for w in orig)
    return kw.get("low", 0) <= similar <= kw.get("high", 10**9)


def constrained_start(text: str, kw) -> bool:
    """reference: ifeval ConstrainedStartChecker — some line of the
    (multi-turn) response starts with ``starter``."""
    starter = str(kw.get("starter", "")).strip()
    return bool(
        re.search(r"^\s*" + re.escape(starter), text, flags=re.MULTILINE)
    )


CHECKERS: Dict[str, Checker] = {
    "keywords:key_sentences": key_sentences,
    "detectable_format:rephrase": rephrase,
    "detectable_content:rephrase_paragraph": rephrase_paragraph,
    "multi-turn:constrained_start": constrained_start,
    "keywords:existence": keywords_existence,
    "keywords:frequency": keywords_frequency,
    "keywords:forbidden_words": keywords_forbidden,
    "keywords:letter_frequency": letter_frequency,
    "length_constraints:number_words": number_words,
    "length_constraints:number_sentences": number_sentences,
    "length_constraints:number_paragraphs": number_paragraphs,
    "length_constraints:nth_paragraph_first_word": nth_paragraph_first_word,
    "detectable_content:number_placeholders": number_placeholders,
    "detectable_content:postscript": postscript,
    "detectable_format:number_bullet_lists": number_bullet_lists,
    "detectable_format:constrained_response": constrained_response,
    "detectable_format:number_highlighted_sections": number_highlighted_sections,
    "detectable_format:multiple_sections": multiple_sections,
    "detectable_format:json_format": json_format,
    "detectable_format:title": title,
    "combination:repeat_prompt": repeat_prompt,
    "combination:two_responses": two_responses,
    "startend:end_checker": end_checker,
    "startend:quotation": quotation,
    "change_case:capital_word_frequency": capital_word_frequency,
    "change_case:english_capital": english_capital,
    "change_case:english_lowercase": english_lowercase,
    "punctuation:no_comma": no_comma,
    "language:response_language": response_language,
}


def _loose_variants(response: str) -> List[str]:
    """The loose protocol's response variants (remove first/last line,
    strip asterisks, and combinations)."""
    lines = response.split("\n")
    variants = [
        response,
        response.replace("*", ""),
        "\n".join(lines[1:]).strip(),
        "\n".join(lines[:-1]).strip(),
        "\n".join(lines[1:-1]).strip(),
    ]
    variants += [v.replace("*", "") for v in variants[2:]]
    return [v for v in variants if v]


def evaluate_instructions(
    response: str,
    instruction_id_list: List[str],
    kwargs_list: List[Dict[str, Any]],
    *,
    strict: bool = True,
) -> List[bool]:
    """Per-instruction pass/fail."""
    results = []
    for inst_id, kw in zip(instruction_id_list, kwargs_list):
        checker = CHECKERS.get(inst_id)
        if checker is None:
            results.append(False)
            continue
        kw = {k: v for k, v in (kw or {}).items() if v is not None}
        if strict:
            results.append(bool(checker(response, kw)))
        else:
            results.append(
                any(checker(v, kw) for v in _loose_variants(response))
            )
    return results


def ifeval_score(samples: List[Dict[str, Any]], strict: bool = True) -> Dict[str, float]:
    """samples: [{response, instruction_id_list, kwargs}]. Returns prompt- and
    instruction-level accuracies (the two headline IFEval numbers)."""
    prompt_hits, inst_hits, inst_total = 0, 0, 0
    for s in samples:
        results = evaluate_instructions(
            s["response"], s["instruction_id_list"], s.get("kwargs", [{}] * len(s["instruction_id_list"])),
            strict=strict,
        )
        prompt_hits += all(results)
        inst_hits += sum(results)
        inst_total += len(results)
    n = max(len(samples), 1)
    return {
        "prompt_level_accuracy": prompt_hits / n,
        "instruction_level_accuracy": inst_hits / max(inst_total, 1),
    }
