"""Least time of the work the traced stretch completed (tower, prefill, decode; each phase bound by operations or bytes) over the device's busy time."""

from uvbench.readers import mfu_busy as read  # noqa: F401
