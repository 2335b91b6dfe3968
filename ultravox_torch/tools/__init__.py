"""Checkpoint publishing (``publish.save_pretrained``)."""
