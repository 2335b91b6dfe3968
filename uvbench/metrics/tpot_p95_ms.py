"""95th percentile over the window's turns of (last token time - first token time) / (tokens - 1)."""

from uvbench.readers import tpot_ms as read  # noqa: F401
