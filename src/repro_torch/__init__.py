"""PyTorch/CUDA port of the FedOCS reproduction (``repro``), for an NVIDIA
H100.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core``, ``protocol``, ``kernels``, ``sim``, ``optim``, ``train``,
``data``) and imports neither JAX nor anything of ``repro``.  Its kernels
are CUDA C++ for ``sm_90a`` (``kernels/csrc``), built at first use.  Entry
points run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
