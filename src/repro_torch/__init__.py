"""FedZero scheduling on PyTorch and CUDA.

A port of the reference package ``repro`` that imports none of it: the
host control flow (``core``, ``data``) is the reference's NumPy/SciPy
code, and the array math goes through :mod:`repro_torch.backend`, where
``"torch"`` runs it as PyTorch ops on a device and ``"cuda"`` adds the
hand-written CUDA counter-hash kernels of :mod:`repro_torch.kernels`.
Both run on ``cuda:0`` unless the caller passes a backend instance on
another device.
"""
