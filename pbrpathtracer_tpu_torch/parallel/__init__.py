"""Pixel-sharded rendering and training steps of the PyTorch port, over
``torch.distributed`` (see the package docstring)."""
