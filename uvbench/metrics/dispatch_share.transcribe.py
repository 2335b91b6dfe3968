"""Share of the traced stretch the serving loop spent issuing decode dispatches (the engine's stat_dispatch_s)."""

from uvbench.readers import dispatch_share as read  # noqa: F401
