"""PyTorch / CUDA port of the fluctuating binary-fluid lattice Boltzmann
framework, beside the JAX reference package ``bflbm_tpu``.

The layout of every public function is the JAX package's: populations
(19, X, Y, Z) float32 with z contiguous.  The port imports torch and
numpy only, never JAX.  Its one hand-written CUDA kernel, the fused
collide-stream step, lives in :mod:`bflbm_tpu_torch.kernels.fused_step`.
"""
