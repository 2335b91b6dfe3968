"""Disk cache for expensive task calls: the sha256 of the request payload
(its JSON with sorted keys) keys a JSON or bytes file on disk, so a re-run
of a dataset-factory job skips the calls it already made. The keys and
files are the JAX package's, so a cache written by either package is read
by the other."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable


class DiskCache:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, payload: Any, suffix: str = ".json") -> str:
        digest = hashlib.sha256(
            json.dumps(payload, sort_keys=True, default=str).encode()
        ).hexdigest()
        return os.path.join(self.cache_dir, digest + suffix)

    def _get_or_compute(self, path: str, fn: Callable[[], Any], binary: bool, load, dump):
        mode = "b" if binary else ""
        if os.path.exists(path):
            with open(path, "r" + mode) as f:
                return load(f)
        result = fn()
        tmp = path + ".tmp"
        with open(tmp, "w" + mode) as f:
            dump(result, f)
        os.replace(tmp, path)
        return result

    def get_or_compute(self, payload: Any, fn: Callable[[], Any]) -> Any:
        return self._get_or_compute(self._path(payload), fn, False, json.load, json.dump)

    def get_or_compute_bytes(self, payload: Any, fn: Callable[[], bytes]) -> bytes:
        return self._get_or_compute(self._path(payload, suffix=".bin"), fn, True,
                                    lambda f: f.read(), lambda b, f: f.write(b))


class CachingChatWrapper:
    """An OpenAI-compatible client behind the disk cache: one request per
    distinct set of ``chat.completions.create`` arguments."""

    def __init__(self, client: Any, cache_dir: str = ".cache/ds_tool/chat"):
        self._client = client
        self._cache = DiskCache(cache_dir)

    def chat_completion(self, **kwargs) -> str:
        def compute():
            response = self._client.chat.completions.create(**kwargs)
            return response.choices[0].message.content

        return self._cache.get_or_compute({"chat": kwargs}, compute)
