"""Least time of the work the traced stretch completed (tower, prefill, decode; each phase bound by operations or bytes) over its wall time."""

from uvbench.readers import mfu_wall as read  # noqa: F401
