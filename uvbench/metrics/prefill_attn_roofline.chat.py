"""Least time of the prefill attention work (visible keys only, per chunk and layer) over the device time of fused_attention (#4)."""

from uvbench.readers import prefill_attn_roofline as read  # noqa: F401
