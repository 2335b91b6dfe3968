"""Dataset factory: ``python -m ultravox_torch.tools.ds_tool.ds_tool``."""
