"""goslam_tpu_torch -- the PyTorch/CUDA port of goslam_tpu.

A second package beside the JAX one, with the same module names
(ops/, models/, tracking/, system.py) and the same public layouts (NHWC
features, [tx ty tz qx qy qz qw] poses).  It imports torch and never
jax, and nothing of goslam_tpu.  The hand-written CUDA kernels live in
csrc/ and are built with nvcc at first use (ops/kernels.py).
"""
