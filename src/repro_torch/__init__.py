"""PyTorch port of the Mango tuner for NVIDIA Hopper GPUs.

A second package beside the JAX reference ``repro``; it imports nothing of
it.  Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
