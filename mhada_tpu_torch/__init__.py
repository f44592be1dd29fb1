"""PyTorch + CUDA port of mhada_tpu's 512^2 image-stylization path.

The JAX package ``mhada_tpu`` is the reference; this package mirrors its
module names (``config``, ``ops/*``, ``models/*``, ``infer/image``) and keeps
its public layouts: NHWC float32 pixels in [0, 255] and (B, N, C) tokens.
Every Pallas kernel on the path has a hand-written CUDA counterpart under
``csrc/`` (built by ``_build.py``) with a plain PyTorch twin beside its
wrapper; the twin runs for CPU tensors, the kernel for CUDA tensors.

Nothing here imports jax.
"""
