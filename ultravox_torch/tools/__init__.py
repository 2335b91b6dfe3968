"""Checkpoint publishing (``publish.save_pretrained``) and the OpenAI-protocol
client (``infer_api.OpenAIInference``)."""
