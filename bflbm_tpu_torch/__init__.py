"""PyTorch / CUDA port of the fluctuating binary-fluid lattice Boltzmann
framework, beside the JAX reference package ``bflbm_tpu``.

The layout of every public function is the JAX package's: populations
(19, X, Y, Z) float32 with z contiguous.  The port imports torch and
numpy only, never JAX.  Its hand-written CUDA kernels, the fused
collide-stream step and the density pre-pass of its coupled mode, are
driven from :mod:`bflbm_tpu_torch.kernels.fused_step`; a run starts from
``models.binary_fluid.make_initial_state(config.preset(...))`` and
``kernels.session.make_session``, or on a decomposed domain from
``make_session(..., mesh=parallel.mesh.make_mesh(shape))``.
"""
