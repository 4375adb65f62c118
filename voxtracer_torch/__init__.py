"""voxtracer_torch — the voxel path tracer in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

The package mirrors ``voxtracer/`` folder by folder (``core/ world/
kernels/ render/ app/``) and is held against it test by test. It imports
``torch`` and never ``jax``, and nothing from ``voxtracer``.

Every function that launches a kernel takes its plain PyTorch version for
tensors on the CPU and the CUDA kernel for tensors on a card; there is no
fallback from one to the other.
"""
