"""Tokenizer loading and helpers.

``load_tokenizer(model_dir)`` is the port's counterpart of
``transformers.AutoTokenizer.from_pretrained(model_dir)`` for a fast
tokenizer, built on the ``tokenizers`` and ``jinja2`` packages only. It
reads ``tokenizer.json``, ``tokenizer_config.json`` (special tokens given as
a string or as an AddedToken dict, ``added_tokens_decoder``, and
``chat_template`` as a string or a list of named templates),
``special_tokens_map.json`` and ``chat_template.jinja``. The ``Tokenizer``
it returns has what the port's callers use: ``__call__`` / ``encode``,
``decode`` / ``batch_decode``, ``apply_chat_template``, the bos / eos / pad
tokens and ids, ``padding_side``, ``convert_tokens_to_ids``, ``get_vocab``,
``add_special_tokens`` and ``save_pretrained``.

The chat template renders as ``transformers`` renders it: a sandboxed jinja2
environment with ``trim_blocks`` and ``lstrip_blocks``, the ``loopcontrols``
extension, ``raise_exception``, ``strftime_now``, a ``tojson`` filter that
does not escape HTML, and the special tokens passed as variables.

The ``<|audio|>`` placeholder is *not* in the vocabulary during training
(the processor splits text around it and fills the span with EOS repeats);
serving stacks that tokenize the placeholder directly (e.g. vLLM-protocol
frontends) need it registered as a special token (``add_audio_token``).
"""

from __future__ import annotations

import datetime
import functools
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

AUDIO_TOKEN = "<|audio|>"

SPECIAL_TOKEN_KEYS = (
    "bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token",
)


def _token_content(value) -> Optional[str]:
    """A special token given as a string or as an AddedToken dict."""
    if isinstance(value, dict):
        return value.get("content")
    return value


def _clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``: no space before
    punctuation and English contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


@functools.lru_cache(maxsize=32)
def _compile_chat_template(template: str):
    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        # jinja's own filter escapes HTML characters
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                          sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True, extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(template)


class Tokenizer:
    """A ``tokenizers.Tokenizer`` with the special tokens and chat template
    of its checkpoint directory (see ``load_tokenizer``)."""

    def __init__(
        self,
        backend,
        *,
        special_tokens: Optional[Dict[str, Optional[str]]] = None,
        additional_special_tokens: Sequence[str] = (),
        chat_template: Union[str, Dict[str, str], None] = None,
        padding_side: str = "right",
        clean_up_tokenization_spaces: bool = False,
        config: Optional[Dict[str, Any]] = None,
    ):
        self._tok = backend
        self._special: Dict[str, Optional[str]] = {k: None for k in SPECIAL_TOKEN_KEYS}
        self._special.update(special_tokens or {})
        self.additional_special_tokens: List[str] = list(additional_special_tokens)
        self.chat_template = chat_template
        self.padding_side = padding_side
        self.clean_up_tokenization_spaces = clean_up_tokenization_spaces
        self._config = dict(config or {})
        # a special token the vocabulary lacks is added as a special token,
        # as the fast tokenizer of ``transformers`` does at load time
        missing = [t for t in self._special_token_list() if self._tok.token_to_id(t) is None]
        if missing:
            from tokenizers import AddedToken

            self._tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                                          for t in missing])

    def _special_token_list(self) -> List[str]:
        out = [t for t in self._special.values() if t is not None]
        return out + [t for t in self.additional_special_tokens if t not in out]

    # -- special tokens --------------------------------------------------------

    def _id(self, key: str) -> Optional[int]:
        tok = self._special[key]
        return None if tok is None else self._tok.token_to_id(tok)

    def _set_id(self, key: str, value: Optional[int]) -> None:
        self._special[key] = None if value is None else self._tok.id_to_token(int(value))

    bos_token = property(lambda self: self._special["bos_token"],
                         lambda self, v: self._special.__setitem__("bos_token", _token_content(v)))
    eos_token = property(lambda self: self._special["eos_token"],
                         lambda self, v: self._special.__setitem__("eos_token", _token_content(v)))
    pad_token = property(lambda self: self._special["pad_token"],
                         lambda self, v: self._special.__setitem__("pad_token", _token_content(v)))
    unk_token = property(lambda self: self._special["unk_token"],
                         lambda self, v: self._special.__setitem__("unk_token", _token_content(v)))
    bos_token_id = property(lambda self: self._id("bos_token"),
                            lambda self, v: self._set_id("bos_token", v))
    eos_token_id = property(lambda self: self._id("eos_token"),
                            lambda self, v: self._set_id("eos_token", v))
    pad_token_id = property(lambda self: self._id("pad_token"),
                            lambda self, v: self._set_id("pad_token", v))
    unk_token_id = property(lambda self: self._id("unk_token"),
                            lambda self, v: self._set_id("unk_token", v))

    @property
    def special_tokens_map(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: v for k, v in self._special.items() if v is not None}
        if self.additional_special_tokens:
            out["additional_special_tokens"] = list(self.additional_special_tokens)
        return out

    def add_special_tokens(self, special_tokens_dict: Dict[str, Any]) -> int:
        """Register special tokens (``additional_special_tokens`` or one of
        the named slots); returns how many were new to the vocabulary."""
        from tokenizers import AddedToken

        new: List[str] = []
        for key, value in special_tokens_dict.items():
            if key == "additional_special_tokens":
                toks = [_token_content(v) for v in value]
                self.additional_special_tokens += [
                    t for t in toks if t not in self.additional_special_tokens]
            elif key in SPECIAL_TOKEN_KEYS:
                toks = [_token_content(value)]
                self._special[key] = toks[0]
            else:
                raise ValueError(f"unknown special token key {key!r}")
            new += [t for t in toks if self._tok.token_to_id(t) is None and t not in new]
        return self._tok.add_special_tokens(
            [AddedToken(t, special=True, normalized=False) for t in new]) if new else 0

    # -- vocabulary ----------------------------------------------------------

    def get_vocab(self) -> Dict[str, int]:
        return self._tok.get_vocab(with_added_tokens=True)

    def __len__(self) -> int:
        return self._tok.get_vocab_size(with_added_tokens=True)

    def convert_tokens_to_ids(self, tokens):
        """A token's id (the unk id, or None, when it is not in the
        vocabulary); a list maps element-wise."""
        if isinstance(tokens, str):
            tid = self._tok.token_to_id(tokens)
            return self.unk_token_id if tid is None else tid
        return [self.convert_tokens_to_ids(t) for t in tokens]

    # -- encode / decode -----------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def __call__(self, text: Union[str, Sequence[str]], add_special_tokens: bool = True,
                 **_unused) -> Dict[str, Any]:
        """``{"input_ids", "attention_mask"}``: lists for one text, lists of
        lists for several (no padding)."""
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens)
            return {"input_ids": ids, "attention_mask": [1] * len(ids)}
        encs = self._tok.encode_batch(list(text), add_special_tokens=add_special_tokens)
        return {"input_ids": [e.ids for e in encs],
                "attention_mask": [[1] * len(e.ids) for e in encs]}

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        if hasattr(ids, "tolist"):
            ids = ids.tolist()
        if isinstance(ids, int):
            ids = [ids]
        text = self._tok.decode([int(i) for i in ids], skip_special_tokens=skip_special_tokens)
        clean = (self.clean_up_tokenization_spaces if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        return _clean_up_tokenization(text) if clean else text

    def batch_decode(self, sequences, skip_special_tokens: bool = False, **kw) -> List[str]:
        return [self.decode(s, skip_special_tokens=skip_special_tokens, **kw) for s in sequences]

    # -- chat template -------------------------------------------------------

    def get_chat_template(self, chat_template: Optional[str] = None, tools=None) -> str:
        if isinstance(self.chat_template, dict):
            named = self.chat_template
            if chat_template is not None and chat_template in named:
                return named[chat_template]
            if chat_template is None:
                if tools is not None and "tool_use" in named:
                    return named["tool_use"]
                if "default" in named:
                    return named["default"]
                raise ValueError(f"several chat templates and no default: {sorted(named)}")
        if chat_template is not None:
            return chat_template
        if self.chat_template is None:
            raise ValueError("the tokenizer has no chat template; set tokenizer.chat_template")
        return self.chat_template

    def apply_chat_template(
        self,
        conversation: List[Dict[str, Any]],
        tools=None,
        documents=None,
        chat_template: Optional[str] = None,
        add_generation_prompt: bool = False,
        tokenize: bool = True,
        **kwargs,
    ):
        """The conversation rendered by the chat template: a string with
        ``tokenize=False``, else its ids (no special tokens added)."""
        template = _compile_chat_template(self.get_chat_template(chat_template, tools))
        if hasattr(conversation, "messages"):
            conversation = conversation.messages
        text = template.render(
            messages=conversation, tools=tools, documents=documents,
            add_generation_prompt=add_generation_prompt,
            **{**self.special_tokens_map, **kwargs},
        )
        return self.encode(text, add_special_tokens=False) if tokenize else text

    # -- saving --------------------------------------------------------------

    def save_pretrained(self, out_dir: str) -> None:
        """tokenizer.json, tokenizer_config.json, special_tokens_map.json and
        chat_template.jinja (one template) in ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        self._tok.save(os.path.join(out_dir, "tokenizer.json"))
        config = dict(self._config)
        config.update(self.special_tokens_map)
        config.update(padding_side=self.padding_side,
                      clean_up_tokenization_spaces=self.clean_up_tokenization_spaces,
                      tokenizer_class="PreTrainedTokenizerFast")
        config.pop("chat_template", None)
        if isinstance(self.chat_template, dict):
            config["chat_template"] = [{"name": k, "template": v}
                                       for k, v in self.chat_template.items()]
        elif self.chat_template is not None:
            with open(os.path.join(out_dir, "chat_template.jinja"), "w") as f:
                f.write(self.chat_template)
        with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
            json.dump(config, f, indent=2, ensure_ascii=False)
        with open(os.path.join(out_dir, "special_tokens_map.json"), "w") as f:
            json.dump(self.special_tokens_map, f, indent=2, ensure_ascii=False)


def _read_json(path: str) -> Dict[str, Any]:
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_tokenizer(model_dir: str) -> Tokenizer:
    """The fast tokenizer of a checkpoint directory, as
    ``AutoTokenizer.from_pretrained(model_dir)`` loads it."""
    from tokenizers import AddedToken
    from tokenizers import Tokenizer as Backend

    path = os.path.join(model_dir, "tokenizer.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found: the loader reads fast (tokenizer.json) "
                                "tokenizers only")
    backend = Backend.from_file(path)
    config = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
    smap = _read_json(os.path.join(model_dir, "special_tokens_map.json"))

    # added tokens the config declares that tokenizer.json lacks
    for tid, spec in sorted(config.get("added_tokens_decoder", {}).items(), key=lambda kv: int(kv[0])):
        if backend.token_to_id(spec["content"]) is None:
            tok = AddedToken(spec["content"], single_word=spec.get("single_word", False),
                             lstrip=spec.get("lstrip", False), rstrip=spec.get("rstrip", False),
                             normalized=spec.get("normalized", not spec.get("special", False)),
                             special=spec.get("special", False))
            if spec.get("special", False):
                backend.add_special_tokens([tok])
            else:
                backend.add_tokens([tok])

    special = {}
    for key in SPECIAL_TOKEN_KEYS:
        value = config.get(key, smap.get(key))
        special[key] = _token_content(value)
    additional = [_token_content(t) for t in
                  config.get("additional_special_tokens", smap.get("additional_special_tokens", []))]

    chat_template = config.get("chat_template")
    if isinstance(chat_template, list):
        chat_template = {t["name"]: t["template"] for t in chat_template}
    jinja_path = os.path.join(model_dir, "chat_template.jinja")
    if os.path.isfile(jinja_path):
        with open(jinja_path) as f:
            chat_template = f.read()
    return Tokenizer(
        backend, special_tokens=special, additional_special_tokens=additional,
        chat_template=chat_template, padding_side=config.get("padding_side", "right"),
        clean_up_tokenization_spaces=bool(config.get("clean_up_tokenization_spaces", False)),
        config={k: v for k, v in config.items()
                if k not in SPECIAL_TOKEN_KEYS and k not in ("added_tokens_decoder",
                                                            "additional_special_tokens")},
    )


def add_audio_token(tokenizer) -> int:
    """Register the audio placeholder as a special token; returns its id."""
    if AUDIO_TOKEN not in tokenizer.get_vocab():
        tokenizer.add_special_tokens(
            {"additional_special_tokens": [AUDIO_TOKEN]}
        )
    return tokenizer.convert_tokens_to_ids(AUDIO_TOKEN)


def get_audio_token_id(tokenizer) -> Optional[int]:
    vocab = tokenizer.get_vocab()
    return vocab.get(AUDIO_TOKEN)
