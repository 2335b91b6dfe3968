"""Prompt tokens of the window's turns served from a cached conversation prefix (each request's reused_prefix) over all their prompt tokens."""

from uvbench.readers import prefix_reuse_share as read  # noqa: F401
