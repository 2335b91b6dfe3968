"""ultravox_torch: the Ultravox speech-LLM on PyTorch and CUDA (NVIDIA Hopper).

A port of ``ultravox_tpu`` beside it. Plain tensor code is PyTorch; each
Pallas kernel of the TPU package on the ported path is a hand-written CUDA
kernel for ``sm_90a`` under ``ops/kernels/csrc``. Importing this package
builds and loads nothing: kernels are compiled on their first launch.

Entry points: ``ultravox_torch.inference.engine.GenerationEngine`` and
``inference.serving.engine.ServingEngine`` (serving),
``inference.serving.api_server.serve`` (the HTTP server and the voice
WebSocket, over ``inference.streaming.StreamingAudioEncoder``),
``ultravox_torch.training.train_step.make_train_step`` (training), and
``inference.ultravox_infer.load_ultravox_checkpoint`` /
``tools.publish.save_pretrained`` (checkpoints).
"""

__version__ = "0.1.0"
