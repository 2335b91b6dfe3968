"""The training step: adapter-only or partially frozen training with
optional KL distillation against the text-only teacher."""
