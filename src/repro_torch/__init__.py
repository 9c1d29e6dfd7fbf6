"""PyTorch/CUDA port of the FMMU serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``configs``, ``core/fmmu``, ``paging``, ``kernels``,
``models``, ``serving``) and imports nothing from it, nor JAX. Every
Pallas kernel on the ported path is a hand-written CUDA kernel for
Hopper (``csrc/``), built with nvcc at first use; beside each sits a
plain-torch version that runs on CPU tensors and that the kernels are
held against on the card.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``.
"""
