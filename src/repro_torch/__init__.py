"""PyTorch/CUDA port of the DPPS / PartPSP reproduction (``repro``).

``repro`` (JAX + Pallas) stays the reference; this package mirrors its
module names (``core``, ``kernels``, ``engine``, ``api``, ``data``,
``net``, ``wire``, ``audit``, ``models``, ``configs``, ``launch``) and
runs the protocol, training and serving on an NVIDIA GPU with
hand-written Hopper kernels (``repro_torch.kernels``). It imports
``torch``, ``numpy``, the standard library, and ``scipy`` for the audit
lab's Clopper-Pearson bounds.

Device rule: every entry point runs on CUDA unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
