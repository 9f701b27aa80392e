"""LogicSparse in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``repro`` (the JAX/Pallas reference, which it never imports):
the same module layout and names, plain functions on tensors and dicts of
tensors.  Entry points run on CUDA unless called with ``device="cpu"``.
"""
