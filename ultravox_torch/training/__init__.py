"""Training: the config and recipes (``config``), the model pack
(``model_factory``), the step (``train_step``: KL distillation against the
text-only teacher, gradient accumulation), checkpoints (``checkpoint``) and
the loop and CLI (``train``)."""
