"""repro_torch: the Vortex system ported to PyTorch and CUDA on one H100.

A package beside the JAX reference ``repro``, mirroring its layout
(``core/``, ``kernels/``, ``vortex/``, ``models/``, ``configs/``,
``launch/``).  It imports torch and numpy only, never jax or ``repro``.
Its entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU.
"""
