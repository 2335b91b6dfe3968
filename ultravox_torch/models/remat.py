"""The port's one activation-recompute policy (the reference's jax.checkpoint)."""

from torch.utils.checkpoint import checkpoint


def remat(fn, *args):
    """fn(*args) with its activations recomputed in the backward. Nothing the
    models checkpoint draws random numbers, so no RNG state is kept."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
