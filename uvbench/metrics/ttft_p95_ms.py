"""95th percentile of the time from when a turn was due to its first token at the client, over every turn due in the window (a failed turn is missing)."""

from uvbench.readers import ttft_ms as read  # noqa: F401
