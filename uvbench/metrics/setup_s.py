"""Seconds from process start to the window's opening: loading, building, making the weights, warming up, the ramp of traffic."""

from uvbench.readers import setup_s_reader as read  # noqa: F401
