"""Gradients, losses and fitting of the PyTorch port (see the package
docstring)."""
