"""repro_torch: the PyTorch/CUDA port of the WSMC serving stack. Same
layout and names as the reference package; imports torch, never the
reference package."""

__version__ = "0.1.0"
