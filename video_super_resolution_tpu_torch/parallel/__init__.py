"""Parallel modes of the PyTorch port on ``torch.distributed``: temporal
context parallelism, spatial (H) strips, tensor parallelism of the SR
trunk; data parallelism is in ``training/step.py``."""
