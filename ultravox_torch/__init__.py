"""ultravox_torch: the Ultravox speech-LLM on PyTorch and CUDA (NVIDIA Hopper).

A port of ``ultravox_tpu`` beside it. Plain tensor code is PyTorch; each
Pallas kernel of the TPU package on the ported path is a hand-written CUDA
kernel for ``sm_90a`` under ``ops/kernels/csrc``. Importing this package
builds and loads nothing: kernels are compiled on their first launch.

Entry points, each on the CUDA card unless given ``device="cpu"``:

- offline: ``ultravox_torch.pipeline(model_dir)``,
  ``inference.ultravox_infer.UltravoxInference`` and
  ``inference.infer.LocalInference`` (single, batch, streaming and
  conversation-mode inference on ``inference.engine.GenerationEngine``);
- serving: ``inference.serving.engine.ServingEngine`` (continuous batching,
  prompt-lookup speculative decoding with ``spec_decode="ngram"``), the
  HTTP server and the voice WebSocket (``inference.serving.api_server``:
  ``python -m ultravox_torch.inference.serving.api_server --model DIR``,
  or ``build_api`` and ``serve``, over
  ``inference.streaming.StreamingAudioEncoder``) and its client
  ``tools.infer_api.OpenAIInference``;
- training: ``training.train_step.make_train_step``;
- checkpoints: ``inference.ultravox_infer.load_ultravox_checkpoint``,
  ``models.tokenizer.load_tokenizer`` and ``tools.publish.save_pretrained``.
"""

__version__ = "0.1.0"


def pipeline(model: str, **kwargs):
    """One-call speech + text inference (``ultravox_torch.pipeline``); the
    import is lazy, so ``import ultravox_torch`` stays light."""
    from ultravox_torch.pipeline import pipeline as _pipeline

    # importing the submodule binds its name over this function: restore it
    # so that ``ultravox_torch.pipeline(...)`` works more than once
    globals()["pipeline"] = _entry
    return _pipeline(model, **kwargs)


_entry = pipeline
