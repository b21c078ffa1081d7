"""PyTorch / CUDA port of ``ghicp_tpu`` for NVIDIA Hopper GPUs.

Layout mirrors the JAX package: ``core`` (config, padded clouds,
transforms, device choice), ``preprocess``, ``features``, ``matching``,
``registration``, ``io``; ``ops`` holds the wrappers of the hand-written
kernels (``csrc/`` for the CUDA sources) beside their plain PyTorch
versions.  Entry points run on the card unless called with
``device="cpu"``.
"""
