"""String metrics: WER / CER with Whisper-style normalisation, BLEU, exact /
partial match.

Re-design of the reference's ``evaluation/string_metrics.py``: WER/CER via an
in-repo Levenshtein (replacing the jiwer dependency), Whisper's English
normaliser from the port's own copy (``english_normalizer.py``), BLEU via
sacrebleu with language-aware tokenizers (imported when BLEU is asked for:
where it is missing BLEU raises ``ImportError``), Arabic diacritic
stripping, CJK char-split CER, and hypothesis-length capping.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Sequence

from ultravox_torch.evaluation.english_normalizer import EnglishTextNormalizer


def _levenshtein(ref: Sequence, hyp: Sequence) -> int:
    """Edit distance, O(len(ref)·len(hyp)) with two rows."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return prev[-1]


# -- normalisers ---------------------------------------------------------------

_ARABIC_DIACRITICS = re.compile(r"[ؐ-ًؚ-ٰٟۖ-ۜ۟-۪ۨ-ۭ]")


def remove_diacritics(text: str) -> str:
    return _ARABIC_DIACRITICS.sub("", text)


def basic_normalize(text: str) -> str:
    """Whisper BasicTextNormalizer semantics: strip bracketed annotations,
    lowercase, drop symbols/diacritics (keeping letters/digits/spaces),
    collapse whitespace."""
    text = re.sub(r"[<\[][^>\]]*[>\]]", "", text)
    text = re.sub(r"\(([^)]+?)\)", "", text)
    text = text.lower()
    text = unicodedata.normalize("NFKD", text)
    out = []
    for ch in text:
        cat = unicodedata.category(ch)
        if cat.startswith("M"):
            continue  # combining marks (diacritics)
        if cat.startswith(("L", "N")) or ch.isspace():
            out.append(ch)
        else:
            out.append(" ")
    return re.sub(r"\s+", " ", "".join(out)).strip()


# British -> American spelling canonicalisation: the most common ASR-relevant
# subset of Whisper's english.json mapping (the full ~1.7k-entry file ships
# with the whisper_normalizer package, unavailable offline; reference:
# string_metrics.py:20-64 relies on it via EnglishTextNormalizer).
_SPELLING_GB_US = {
    "accessorise": "accessorize", "acknowledgement": "acknowledgment",
    "aeroplane": "airplane", "ageing": "aging", "aluminium": "aluminum",
    "amortise": "amortize", "analogue": "analog", "analyse": "analyze",
    "apologise": "apologize", "arbour": "arbor", "ardour": "ardor",
    "armour": "armor", "authorise": "authorize", "behaviour": "behavior",
    "calibre": "caliber", "cancelled": "canceled", "capitalise": "capitalize",
    "catalogue": "catalog", "categorise": "categorize", "centre": "center",
    "characterise": "characterize", "cheque": "check", "civilise": "civilize",
    "colour": "color", "colourful": "colorful", "colours": "colors",
    "cosy": "cozy", "counselling": "counseling", "criticise": "criticize",
    "defence": "defense", "dialogue": "dialog", "dramatise": "dramatize",
    "emphasise": "emphasize", "endeavour": "endeavor", "energise": "energize",
    "equalise": "equalize", "favour": "favor", "favourable": "favorable",
    "favourite": "favorite", "fibre": "fiber", "finalise": "finalize",
    "flavour": "flavor", "fuelled": "fueled", "fulfil": "fulfill",
    "generalise": "generalize", "glamour": "glamor", "grey": "gray",
    "harbour": "harbor", "harmonise": "harmonize", "honour": "honor",
    "honourable": "honorable", "humour": "humor", "idealise": "idealize",
    "instalment": "installment", "italicise": "italicize",
    "jewellery": "jewelry", "judgement": "judgment", "kilometre": "kilometer",
    "labelled": "labeled", "labour": "labor", "legalise": "legalize",
    "licence": "license", "litre": "liter", "localise": "localize",
    "manoeuvre": "maneuver", "marvellous": "marvelous",
    "maximise": "maximize", "memorise": "memorize", "metre": "meter",
    "minimise": "minimize", "mobilise": "mobilize", "modelling": "modeling",
    "modernise": "modernize", "mould": "mold", "neighbour": "neighbor",
    "neighbourhood": "neighborhood", "neighbours": "neighbors",
    "normalise": "normalize", "odour": "odor", "offence": "offense",
    "optimise": "optimize", "organise": "organize",
    "organisation": "organization", "oxidise": "oxidize",
    "paralyse": "paralyze", "parlour": "parlor", "penalise": "penalize",
    "personalise": "personalize", "plough": "plow", "practise": "practice",
    "pretence": "pretense", "prioritise": "prioritize",
    "privatise": "privatize", "programme": "program", "publicise": "publicize",
    "pyjamas": "pajamas", "realise": "realize", "recognise": "recognize",
    "rumour": "rumor", "sabre": "saber", "saviour": "savior",
    "savour": "savor", "sceptical": "skeptical", "signalling": "signaling",
    "socialise": "socialize", "specialise": "specialize",
    "splendour": "splendor", "stabilise": "stabilize",
    "standardise": "standardize", "summarise": "summarize",
    "symbolise": "symbolize", "sympathise": "sympathize",
    "theatre": "theater", "travelled": "traveled", "traveller": "traveler",
    "travelling": "traveling", "tyre": "tire", "utilise": "utilize",
    "valour": "valor", "vapour": "vapor", "vigour": "vigor",
    "visualise": "visualize",
}

_ENGLISH_NORMALIZER = EnglishTextNormalizer(_SPELLING_GB_US)


def english_normalize(text: str) -> str:
    """Whisper EnglishTextNormalizer semantics (reference:
    string_metrics.py:20-64): annotation stripping, contraction expansion,
    number-word/currency/ordinal canonicalisation, British->American
    spelling, punctuation removal."""
    return _ENGLISH_NORMALIZER(text)


_CJK_RE = re.compile(r"[一-鿿぀-ヿ가-힯]")


def _is_cjk(text: str) -> bool:
    chars = [c for c in text if not c.isspace()]
    if not chars:
        return False
    cjk = sum(1 for c in chars if _CJK_RE.match(c))
    return cjk / len(chars) > 0.5


# -- corpus metrics --------------------------------------------------------------


def wer(
    references: List[str],
    hypotheses: List[str],
    *,
    language: Optional[str] = "en",
    cap_length_ratio: float = 4.0,
) -> float:
    """Corpus word error rate in [0, 100]-ish (can exceed 100), with
    language-aware normalisation, CJK char splitting, Arabic diacritic
    stripping, and hypothesis-length capping (reference:
    string_metrics.py:20-64)."""
    total_edits, total_words = 0, 0
    norm = english_normalize if (language or "en").startswith("en") else basic_normalize
    for ref, hyp in zip(references, hypotheses):
        if language == "ar":
            ref, hyp = remove_diacritics(ref), remove_diacritics(hyp)
        ref_n, hyp_n = norm(ref), norm(hyp)
        if _is_cjk(ref_n):
            ref_t: Sequence = [c for c in ref_n if not c.isspace()]
            hyp_t = [c for c in hyp_n if not c.isspace()]
        else:
            ref_t = ref_n.split()
            hyp_t = hyp_n.split()
        if cap_length_ratio and len(hyp_t) > cap_length_ratio * max(len(ref_t), 1):
            hyp_t = hyp_t[: int(cap_length_ratio * max(len(ref_t), 1))]
        total_edits += _levenshtein(ref_t, hyp_t)
        total_words += max(len(ref_t), 1)
    return 100.0 * total_edits / max(total_words, 1)


def cer(references: List[str], hypotheses: List[str], **kw) -> float:
    total_edits, total_chars = 0, 0
    for ref, hyp in zip(references, hypotheses):
        ref_n = basic_normalize(ref).replace(" ", "")
        hyp_n = basic_normalize(hyp).replace(" ", "")
        total_edits += _levenshtein(ref_n, hyp_n)
        total_chars += max(len(ref_n), 1)
    return 100.0 * total_edits / max(total_chars, 1)


def bleu(
    references: List[str],
    hypotheses: List[str],
    *,
    language: Optional[str] = "en",
) -> float:
    """Corpus BLEU via sacrebleu with language-aware tokenizers (reference:
    string_metrics.py bleu)."""
    import sacrebleu

    tok = {"zh": "zh", "ja": "ja-mecab", "ko": "ko-mecab"}.get(
        (language or "en").split("_")[0].split("-")[0], "13a"
    )
    try:
        score = sacrebleu.corpus_bleu(hypotheses, [references], tokenize=tok)
    except Exception:
        score = sacrebleu.corpus_bleu(hypotheses, [references], tokenize="13a")
    return score.score


# -- sample metrics ----------------------------------------------------------------


def exact_match_last_word(expected: str, generated: str) -> float:
    """Compare the final word (reference: boolq-style answers)."""
    last = lambda s: re.findall(r"\w+", s.lower())[-1:] or [""]
    return float(last(expected) == last(generated))


def exact_match(expected: str, generated: str) -> float:
    return float(expected.strip().lower() == generated.strip().lower())


def partial_match(expected: str, generated: str) -> float:
    return float(expected.strip().lower() in generated.strip().lower())
