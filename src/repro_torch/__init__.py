"""repro_torch: the PyTorch and CUDA port of ``repro``.

Runs the paper's Section-3 ``simulate`` engine (``core/staleness.py``), the
gradient-ring modes ``stale-psum``, ``ssp`` and ``sync``
(``core/stale_sync.py``, ``core/ssp.py``), the compensation layer
(``compensate/``), the coherence monitor and hooks, and the serving plane
(``serving/``) over the dense transformers (``models/transformer.py``,
``configs/``), with the packed delivery, Adam, megakernel, EF-split,
coherence and paged decode-attention passes as hand-written CUDA kernels
(``kernels/csrc``). Module names follow ``repro`` so that each counterpart
sits at the same relative path. The package imports ``torch`` and numpy and
nothing of ``jax`` or ``repro``.

Entry points (``engine.build_engine``, ``Engine.init``, ``models.mlp.init``,
``experiments.dnn_experiment``, ``configs.get(...).api().init``,
``serving.Server``, ``python -m repro_torch.launch.serve``) run on CUDA
unless the caller passes ``device="cpu"`` (``--cpu``); without CUDA they
raise rather than fall back.
"""

__version__ = "0.1.0"
