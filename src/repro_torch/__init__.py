"""PyTorch/CUDA port of the superblock-pruned sparse retrieval system.

Mirrors the layout of the JAX package (``index/``, ``core/``, ``api/``,
``data/``, ``eval/``, ``kernels/``) module for module, so each function's
counterpart is easy to find. Every entry point runs on the CUDA device unless
the caller passes ``device="cpu"``; on the CPU each kernel wrapper runs its
plain PyTorch version.
"""
