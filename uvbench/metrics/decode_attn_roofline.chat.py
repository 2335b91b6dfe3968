"""Bytes of keys and values each decoded token must read, at 3.35 TB/s, over the device time of the decode attention kernels (#8-#12 by name)."""

from uvbench.readers import decode_attn_roofline as read  # noqa: F401
