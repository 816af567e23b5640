"""Hand-written CUDA kernels for the port's hot spots (``csrc/*.cu``), their
plain PyTorch versions (``ref.py``) and the device-based dispatcher
(``dispatch.py``). Nothing is compiled at import: ``build.library()`` runs
``nvcc`` on first use."""
