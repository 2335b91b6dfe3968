"""Continuous-batching serving (``engine.ServingEngine``)."""
