"""Serving: the continuous-batching engine (``engine.ServingEngine``) and
the OpenAI-protocol HTTP server with the voice WebSocket
(``api_server.ServingAPI``, ``api_server.serve``)."""

from ultravox_torch.inference.serving.engine import ServingEngine  # noqa: F401
