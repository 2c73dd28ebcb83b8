"""accel of the PyTorch port: the host-built BVH (see ``build.py``)."""
