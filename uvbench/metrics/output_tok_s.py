"""Output tokens delivered in the window over its seconds."""

from uvbench.readers import output_tok_s as read  # noqa: F401
