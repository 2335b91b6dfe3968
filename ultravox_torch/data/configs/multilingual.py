"""Multilingual corpus configs (reference: data/configs/commonvoice.py —
~50 languages; multilingual_librispeech.py, voxpopuli.py, wenetspeech.py,
fleurs.py).

Split sample counts are declared lengths used for interleave weighting and
progress bars (streaming datasets, datasets.py:77-94); values are
approximate where the corpus publishes rounded sizes.
"""

from __future__ import annotations

from typing import List

from ultravox_torch.data import types
from ultravox_torch.data.types import (
    CONTINUATION_PROMPTS,
    TRANSCRIPTION_PROMPTS_LANGUAGE,
    DatasetConfig,
    DatasetSplitConfig,
    EvalConfig,
)

# language code -> (name, approx train samples) for common_voice_17_0
COMMONVOICE_LANGS = {
    "en": ("English", 1_101_170), "de": ("German", 589_100),
    "fr": ("French", 558_054), "es": ("Spanish", 336_846),
    "it": ("Italian", 169_771), "ca": ("Catalan", 1_047_554),
    "pl": ("Polish", 20_729), "pt": ("Portuguese", 21_968),
    "ru": ("Russian", 26_377), "nl": ("Dutch", 34_898),
    "tr": ("Turkish", 35_147), "uk": ("Ukrainian", 25_137),
    "ar": ("Arabic", 28_369), "ja": ("Japanese", 10_039),
    "zh-CN": ("Chinese", 30_000), "hi": ("Hindi", 9_378),
    "sv-SE": ("Swedish", 7_744), "cs": ("Czech", 20_144),
    "ro": ("Romanian", 5_141), "hu": ("Hungarian", 19_770),
    "el": ("Greek", 2_251), "fi": ("Finnish", 2_076),
    "da": ("Danish", 3_484), "bg": ("Bulgarian", 4_849),
    "sk": ("Slovak", 3_525), "sl": ("Slovenian", 1_288),
    "hr": ("Croatian", 1_372), "et": ("Estonian", 3_157),
    "lt": ("Lithuanian", 4_384), "lv": ("Latvian", 5_552),
    "mt": ("Maltese", 2_140), "ga-IE": ("Irish", 541),
    "cy": ("Welsh", 7_960), "eu": ("Basque", 13_621),
    "gl": ("Galician", 8_661), "be": ("Belarusian", 347_637),
    "ta": ("Tamil", 35_924), "bn": ("Bengali", 18_293),
    "ur": ("Urdu", 4_618), "fa": ("Persian", 27_240),
    "id": ("Indonesian", 7_156), "th": ("Thai", 27_158),
    "vi": ("Vietnamese", 2_575), "ko": ("Korean", 420),
    "sw": ("Swahili", 35_369), "yo": ("Yoruba", 1_056),
    "uz": ("Uzbek", 44_186), "kk": ("Kazakh", 555),
    "az": ("Azerbaijani", 205), "ka": ("Georgian", 40_287),
    "br": ("Breton", 2_780), "mk": ("Macedonian", 1_686),
    "ml": ("Malayalam", 811), "mn": ("Mongolian", 2_175),
    "mr": ("Marathi", 2_415), "oc": ("Occitan", 846),
    "sr": ("Serbian", 984),
}

FLEURS_LANGS = [
    "en_us", "de_de", "es_419", "fr_fr", "it_it", "ja_jp", "pt_br",
    "ru_ru", "ko_kr", "cmn_hans_cn", "hi_in", "ar_eg", "tr_tr", "pl_pl",
    "nl_nl", "sv_se", "uk_ua", "vi_vn", "id_id", "th_th", "ta_in",
    "te_in", "bn_in", "sw_ke", "fi_fi", "el_gr", "he_il", "hu_hu",
    "cs_cz", "da_dk", "nb_no", "ro_ro", "sk_sk", "bg_bg", "hr_hr",
]

MLS_LANGS = {
    "german": 469_942, "dutch": 374_287, "french": 258_213,
    "spanish": 220_701, "italian": 59_623, "portuguese": 37_533,
    "polish": 25_043,
}

VOXPOPULI_LANGS = {
    "en": 182_466, "de": 108_473, "fr": 76_281, "es": 50_922,
    "pl": 25_680, "it": 21_767, "ro": 10_690, "hu": 8_337,
    "cs": 18_066, "nl": 9_166, "fi": 5_855, "hr": 7_896,
    "sk": 8_764, "sl": 3_594, "et": 2_964, "lt": 1_244,
}


def _lang_transcription_leaf(base: str, language: str) -> DatasetConfig:
    return DatasetConfig(
        name=f"{base}-transcription",
        base=base,
        user_template=TRANSCRIPTION_PROMPTS_LANGUAGE[0],
        user_template_args={"language": language},
        eval_config=EvalConfig(metric="wer"),
    )


def configs() -> List[DatasetConfig]:
    out: List[DatasetConfig] = []

    # -- Common Voice 17, full language sweep ----------------------------
    for lang, (name, n_train) in COMMONVOICE_LANGS.items():
        cfg_name = f"commonvoice-{lang}"
        out.append(
            DatasetConfig(
                name=cfg_name,
                base="commonvoice",
                subset=lang,
                splits=[
                    DatasetSplitConfig(name="train", num_samples=n_train),
                    DatasetSplitConfig(
                        name="test",
                        num_samples=5_000,
                        split=types.DatasetSplit.TEST,
                    ),
                ],
            )
        )
        leaf = _lang_transcription_leaf(cfg_name, name)
        leaf.assistant_template = "{{sentence}}"
        leaf.transcript_template = "{{sentence}}"
        leaf.eval_config.args = {"lang_id": lang.split("-")[0]}
        out.append(leaf)
        # continuation leaves per language (reference: configs/commonvoice.py
        # CV_*_CONT_CONFIG entries — the v0.6 recipes train on them)
        out.append(
            DatasetConfig(
                name=f"{cfg_name}-continuation",
                base=cfg_name,
                user_template=CONTINUATION_PROMPTS[0],
                assistant_template="{{continuation}}",
                transcript_template="{{sentence}}",
                eval_config=EvalConfig(metric="bleu"),
            )
        )

    # -- Multilingual LibriSpeech ------------------------------------------
    out.append(
        DatasetConfig(
            name="mls",
            path="facebook/multilingual_librispeech",
            transcript_template="{{transcript}}",
        )
    )
    for lang, n_train in MLS_LANGS.items():
        cfg_name = f"mls-{lang}"
        out.append(
            DatasetConfig(
                name=cfg_name,
                base="mls",
                subset=lang,
                splits=[
                    DatasetSplitConfig(name="train", num_samples=n_train),
                    DatasetSplitConfig(
                        name="test",
                        num_samples=3_000,
                        split=types.DatasetSplit.TEST,
                    ),
                ],
            )
        )
        leaf = _lang_transcription_leaf(cfg_name, lang.capitalize())
        leaf.assistant_template = "{{transcript}}"
        leaf.transcript_template = "{{transcript}}"
        out.append(leaf)
        # continuation leaves (reference: configs/multilingual_librispeech.py
        # MLS_*_CONT_CONFIG — the v0.4.1/v0.5 recipes train on nl/pt)
        out.append(
            DatasetConfig(
                name=f"{cfg_name}-continuation",
                base=cfg_name,
                user_template=CONTINUATION_PROMPTS[0],
                assistant_template="{{continuation}}",
                transcript_template="{{transcript}}",
                eval_config=EvalConfig(metric="bleu"),
            )
        )

    # -- VoxPopuli --------------------------------------------------------
    out.append(
        DatasetConfig(
            name="voxpopuli",
            path="facebook/voxpopuli",
            transcript_template="{{normalized_text}}",
        )
    )
    for lang, n_train in VOXPOPULI_LANGS.items():
        cfg_name = f"voxpopuli-{lang}"
        out.append(
            DatasetConfig(
                name=cfg_name,
                base="voxpopuli",
                subset=lang,
                splits=[DatasetSplitConfig(name="train", num_samples=n_train)],
            )
        )
        leaf = _lang_transcription_leaf(cfg_name, lang)
        leaf.assistant_template = "{{normalized_text}}"
        leaf.transcript_template = "{{normalized_text}}"
        out.append(leaf)

    # -- WenetSpeech (Mandarin) --------------------------------------------
    out.append(
        DatasetConfig(
            name="wenetspeech",
            path="wenet-e2e/wenetspeech",
            subset="L",
            splits=[DatasetSplitConfig(name="train", num_samples=14_621_415)],
            transcript_template="{{text}}",
        )
    )
    leaf = _lang_transcription_leaf("wenetspeech", "Chinese")
    leaf.assistant_template = "{{text}}"
    leaf.transcript_template = "{{text}}"
    leaf.eval_config.args = {"lang_id": "zh"}
    out.append(leaf)
    out.append(
        DatasetConfig(
            name="wenetspeech-continuation",
            base="wenetspeech",
            user_template=CONTINUATION_PROMPTS[0],
            assistant_template="{{continuation}}",
            transcript_template="{{text}}",
            eval_config=EvalConfig(metric="bleu"),
        )
    )

    # -- FLEURS full sweep ----------------------------------------------------
    for lang in FLEURS_LANGS:
        cfg_name = f"fleurs-{lang}"
        out.append(
            DatasetConfig(
                name=cfg_name,
                base="fleurs",
                subset=lang,
                splits=[
                    DatasetSplitConfig(name="train", num_samples=2_000),
                    DatasetSplitConfig(
                        name="test",
                        num_samples=647,
                        split=types.DatasetSplit.TEST,
                    ),
                ],
            )
        )
        out.append(
            DatasetConfig(
                name=f"{cfg_name}-transcription",
                base=cfg_name,
                user_template=TRANSCRIPTION_PROMPTS_LANGUAGE[0],
                user_template_args={"language": lang.split("_")[0]},
                assistant_template="{{transcription}}",
                transcript_template="{{transcription}}",
                eval_config=EvalConfig(
                    metric="wer", args={"lang_id": lang.split("_")[0]}
                ),
            )
        )
    return out
