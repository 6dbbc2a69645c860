"""PyTorch/CUDA port of the ZNS performance model in ``repro``.

``repro_torch.core`` mirrors ``repro.core``: host-side trace lowering in
numpy, fixpoint solves on the selected device.  ``repro_torch.kernels``
holds the hand-written CUDA kernels for Hopper (sources under ``csrc/``),
each with a plain PyTorch version.  The package imports ``torch`` and
``numpy`` only; CUDA kernels are built at first use.
"""
