"""Least time of the fused tower kernels' work (#1, #2, #3, #5) on the valid frames over their device time."""

from uvbench.readers import encoder_kernel_roofline as read  # noqa: F401
