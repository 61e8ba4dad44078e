"""PyTorch/CUDA port of the DPPS / PartPSP reproduction (``repro``).

``repro`` (JAX + Pallas) stays the reference; this package mirrors its
module names (``core``, ``kernels``, ``engine``, ``api``, ``data``,
``net``, ``models``, ``configs``, ``launch``) and runs the protocol, and
serving of the attention-only model family, on an NVIDIA GPU with
hand-written Hopper kernels (``repro_torch.kernels``). It imports
``torch``, ``numpy`` and the standard library only.

Device rule: every entry point runs on CUDA unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
