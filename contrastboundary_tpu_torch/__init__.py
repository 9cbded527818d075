"""PyTorch/CUDA port of contrastboundary_tpu, for NVIDIA Hopper (sm_90a).

The JAX package beside it is the reference; module names mirror it. This
package imports torch, numpy and scipy only. Hand-written CUDA kernels live
in ``csrc/``, are built by ``kernels/build.py`` on first use and are called
through ``ops/cuda/``; on CPU tensors each wrapper runs its plain PyTorch
version instead.
"""
