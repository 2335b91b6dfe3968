"""Retry helpers for flaky I/O: exponential backoff with jitter as an
explicit decorator, and an audio decode that returns None instead of
raising (the dataset iteration filters None-audio samples)."""

from __future__ import annotations

import functools
import logging
import random
import time
from typing import Callable, Tuple, Type

logger = logging.getLogger(__name__)


def retry(
    max_attempts: int = 5,
    base_delay_s: float = 1.0,
    max_delay_s: float = 30.0,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
) -> Callable:
    """Exponential backoff with jitter: attempt ``a`` (from 0) that fails
    sleeps ``min(base_delay_s * 2**a, max_delay_s) * uniform(0.5, 1.5)``;
    the last attempt's exception propagates."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for attempt in range(max_attempts):
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:
                    if attempt == max_attempts - 1:
                        raise
                    delay = min(base_delay_s * 2**attempt, max_delay_s) * random.uniform(0.5, 1.5)
                    logger.warning("%s failed (%s); retry %d/%d in %.1fs",
                                   fn.__name__, e, attempt + 1, max_attempts, delay)
                    time.sleep(delay)

        return wrapper

    return decorator


def safe_audio_decode(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, or None (with a warning) if it raises."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001
        logger.warning("audio decode failed: %s", e)
        return None
