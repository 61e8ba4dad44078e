"""Hand-written Hopper kernels (``csrc/*.cu``), their wrappers (``ops``)
and plain PyTorch versions (``ref``). Importing this package builds
nothing; a kernel is compiled at its first launch."""
