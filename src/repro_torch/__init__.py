"""repro_torch: the PyTorch and CUDA port of ``repro``.

Runs the paper's Section-3 ``simulate`` engine (``core/staleness.py``), the
gradient-ring modes ``stale-psum``, ``ssp`` and ``sync``
(``core/stale_sync.py``, ``core/ssp.py``) and the compensation layer
(``compensate/``), with the packed delivery, Adam, megakernel and EF-split
passes as hand-written CUDA kernels (``kernels/csrc``). Module names follow
``repro`` so that each counterpart sits at the same relative path. The
package imports ``torch`` and numpy and nothing of ``jax`` or ``repro``.

Entry points (``engine.build_engine``, ``Engine.init``, ``models.mlp.init``,
``experiments.dnn_experiment``) run on CUDA unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back.
"""

__version__ = "0.1.0"
