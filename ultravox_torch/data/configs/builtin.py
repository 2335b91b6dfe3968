"""Built-in dataset configs for the main public corpora the reference trains
and evaluates on (reference: data/configs/ — librispeech.py, gigaspeech.py,
commonvoice.py, peoplespeech.py, fleurs.py, covost2.py, boolq.py, …).

The pattern follows the reference: a base config per corpus (path, splits,
transcript template) and task leaves (``-transcription`` / ``-continuation``)
adding the user/assistant templates and eval metrics.
"""

from __future__ import annotations

from typing import List

from ultravox_torch.data import types
from ultravox_torch.data.types import (
    AUDIO_PLACEHOLDER,
    CONTINUATION_PROMPTS,
    TRANSCRIPTION_PROMPTS,
    DatasetConfig,
    DatasetSplitConfig,
    EvalConfig,
)

def _transcription_leaf(base: str, transcript_template: str) -> DatasetConfig:
    return DatasetConfig(
        name=f"{base}-transcription",
        base=base,
        user_template=TRANSCRIPTION_PROMPTS[0],
        assistant_template=transcript_template,
        transcript_template=transcript_template,
        eval_config=EvalConfig(metric="wer"),
    )


def _continuation_leaf(base: str, transcript_template: str) -> DatasetConfig:
    return DatasetConfig(
        name=f"{base}-continuation",
        base=base,
        user_template=CONTINUATION_PROMPTS[0],
        assistant_template="{{continuation}}",
        transcript_template=transcript_template,
        eval_config=EvalConfig(metric="bleu"),
    )


def configs() -> List[DatasetConfig]:
    out: List[DatasetConfig] = []

    # -- LibriSpeech (reference: configs/librispeech.py) -------------------
    out.append(
        DatasetConfig(
            name="librispeech",
            path="fixie-ai/librispeech_asr",
            transcript_template="{{ text_proc.format_asr_text(text) }}",
        )
    )
    for subset, split_names, counts in [
        ("clean", ["train.clean.100", "train.clean.360"], [28_539, 104_014]),
        ("other", ["train.other.500"], [148_688]),
    ]:
        out.append(
            DatasetConfig(
                name=f"librispeech-{subset}",
                base="librispeech",
                subset=subset,
                splits=[
                    DatasetSplitConfig(name=n, num_samples=c)
                    for n, c in zip(split_names, counts)
                ]
                + [
                    DatasetSplitConfig(
                        name="validation" if subset == "clean" else "validation",
                        num_samples=2703 if subset == "clean" else 2864,
                        split=types.DatasetSplit.VALIDATION,
                    ),
                    DatasetSplitConfig(
                        name="test",
                        num_samples=2620 if subset == "clean" else 2939,
                        split=types.DatasetSplit.TEST,
                    ),
                ],
            )
        )
        out.append(
            _transcription_leaf(
                f"librispeech-{subset}", "{{ text_proc.format_asr_text(text) }}"
            )
        )
        out.append(
            _continuation_leaf(
                f"librispeech-{subset}", "{{ text_proc.format_asr_text(text) }}"
            )
        )

    # -- GigaSpeech (reference: configs/gigaspeech.py) ----------------------
    out.append(
        DatasetConfig(
            name="gigaspeech",
            path="speechcolab/gigaspeech",
            subset="xl",
            splits=[DatasetSplitConfig(name="train", num_samples=8_282_988)],
            transcript_template="{{ text_proc.format_asr_text(text) }}",
        )
    )
    out.append(
        _transcription_leaf("gigaspeech", "{{ text_proc.format_asr_text(text) }}")
    )
    out.append(
        _continuation_leaf("gigaspeech", "{{ text_proc.format_asr_text(text) }}")
    )

    # -- Common Voice (reference: configs/commonvoice.py; per-language) ----
    out.append(
        DatasetConfig(
            name="commonvoice",
            path="fixie-ai/common_voice_17_0",
            transcript_template="{{sentence}}",
        )
    )
    for lang, train_count in [
        ("en", 1_101_170), ("ar", 28_369), ("de", 589_100), ("es", 336_846),
        ("fr", 558_054), ("it", 169_771), ("ja", 10_039), ("pt", 21_968),
        ("ru", 26_377), ("hi", 9_378), ("zh-CN", 30_000), ("nl", 34_898),
        ("tr", 35_147), ("uk", 25_137), ("pl", 20_729), ("sv-SE", 7_744),
    ]:
        out.append(
            DatasetConfig(
                name=f"commonvoice-{lang}",
                base="commonvoice",
                subset=lang,
                splits=[DatasetSplitConfig(name="train", num_samples=train_count)],
            )
        )
        out.append(
            _transcription_leaf(f"commonvoice-{lang}", "{{sentence}}")
        )

    # -- People's Speech (reference: configs/peoplespeech.py) --------------
    out.append(
        DatasetConfig(
            name="peoplespeech",
            path="fixie-ai/peoples_speech",
            subset="clean",
            splits=[
                DatasetSplitConfig(name="train", num_samples=1_501_271),
                DatasetSplitConfig(
                    name="test", num_samples=34_898, split=types.DatasetSplit.TEST
                ),
            ],
            transcript_template="{{ text_proc.format_asr_text(text) }}",
        )
    )
    out.append(
        _transcription_leaf("peoplespeech", "{{ text_proc.format_asr_text(text) }}")
    )
    out.append(
        _continuation_leaf("peoplespeech", "{{ text_proc.format_asr_text(text) }}")
    )

    # -- FLEURS (reference: configs/fleurs.py) ------------------------------
    out.append(
        DatasetConfig(
            name="fleurs",
            path="google/fleurs",
            transcript_template="{{transcription}}",
        )
    )
    for lang in ["en_us", "de_de", "es_419", "fr_fr", "it_it", "ja_jp", "pt_br"]:
        out.append(
            DatasetConfig(
                name=f"fleurs-{lang}",
                base="fleurs",
                subset=lang,
                splits=[
                    DatasetSplitConfig(name="train", num_samples=2_000),
                    DatasetSplitConfig(
                        name="test", num_samples=647, split=types.DatasetSplit.TEST
                    ),
                ],
            )
        )
        out.append(_transcription_leaf(f"fleurs-{lang}", "{{transcription}}"))

    # -- CoVoST2 speech translation (reference: configs/covost2.py) --------
    out.append(
        DatasetConfig(
            name="covost2",
            path="fixie-ai/covost2",
            user_template=(
                "Please translate the text to {{target}}. Your response "
                "should only include the {{target}} translation, without "
                "any additional words:\n\n" + AUDIO_PLACEHOLDER
            ),
            assistant_template="{{translation}}",
            transcript_template="{{sentence}}",
            eval_config=EvalConfig(metric="bleu"),
        )
    )
    # full 36-pair matrix (reference: configs/covost2.py — 15 en->X plus
    # 21 X->en subsets)
    for pair, target, count in [
        ("ar_en", "English", 2_283),
        ("ca_en", "English", 95_854),
        ("cy_en", "English", 1_241),
        ("de_en", "English", 127_834),
        ("en_ar", "Arabic", 289_430),
        ("en_ca", "Catalan", 289_430),
        ("en_cy", "Welsh", 289_430),
        ("en_de", "German", 289_430),
        ("en_et", "Estonian", 289_430),
        ("en_fa", "Persian", 289_430),
        ("en_id", "Indonesian", 289_430),
        ("en_ja", "Japanese", 289_430),
        ("en_lv", "Latvian", 289_430),
        ("en_mn", "Mongolian", 289_430),
        ("en_sl", "Slovenian", 289_430),
        ("en_sv-SE", "Swedish", 289_430),
        ("en_ta", "Tamil", 289_430),
        ("en_tr", "Turkish", 289_430),
        ("en_zh-CN", "Chinese", 289_430),
        ("es_en", "English", 79_015),
        ("et_en", "English", 1_782),
        ("fa_en", "English", 53_949),
        ("fr_en", "English", 207_374),
        ("id_en", "English", 1_243),
        ("it_en", "English", 31_698),
        ("ja_en", "English", 1_119),
        ("lv_en", "English", 2_337),
        ("mn_en", "English", 2_067),
        ("nl_en", "English", 7_108),
        ("pt_en", "English", 9_158),
        ("ru_en", "English", 12_112),
        ("sl_en", "English", 1_843),
        ("sv-SE_en", "English", 2_160),
        ("ta_en", "English", 1_358),
        ("tr_en", "English", 3_966),
        ("zh-CN_en", "English", 7_085),
    ]:
        out.append(
            DatasetConfig(
                name=f"covost2-{pair}",
                base="covost2",
                subset=pair,
                user_template_args={"target": target},
                splits=[
                    DatasetSplitConfig(name="train", num_samples=count),
                    DatasetSplitConfig(
                        name="test", num_samples=2_000, split=types.DatasetSplit.TEST
                    ),
                ],
            )
        )

    # -- BoolQ spoken QA (reference: configs/boolq.py) ----------------------
    out.append(
        DatasetConfig(
            name="boolq",
            path="fixie-ai/boolq-audio",
            splits=[
                DatasetSplitConfig(name="train", num_samples=9_427),
                DatasetSplitConfig(
                    name="validation",
                    num_samples=3_270,
                    split=types.DatasetSplit.TEST,
                ),
            ],
            user_template=(
                "Passage: {{passage}}\n\nQuestion: "
                + AUDIO_PLACEHOLDER
                + "\n\nAnswer the question with only 'True' or 'False'."
            ),
            assistant_template="{{'True' if answer else 'False'}}",
            transcript_template="{{question}}",
            eval_config=EvalConfig(metric="exact_match_last_word"),
        )
    )
    return out
