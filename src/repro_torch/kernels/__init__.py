"""Hand-written CUDA kernels for the H100 (sm_90a), one per Pallas TPU kernel
of the JAX package.

  sbmax           BoundSum / SBMax over packed 4- or 8-bit bounds (phase 1,
                  SBavg, bmp)
  boundsum_gather block BoundSums of the selected superblocks (phase 2)
  doc_score       fused gather + dequant + dot scoring of selected blocks
                  (round 0 and phase 3; forward and flat layouts)
  dequant_matmul  x @ dequant(packed W), the dense-embedding LSP bounds

Each subpackage: kernel.py (ctypes binding of ``csrc/*.cu`` plus a launch counter
per kernel), ref.py (the plain PyTorch version of the same function), ops.py
(the wrapper that clamps ids and applies scales). On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""
