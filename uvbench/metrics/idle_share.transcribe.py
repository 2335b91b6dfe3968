"""Share of the traced window with no operation on the device."""

from uvbench.readers import idle_share as read  # noqa: F401
