"""repro_torch.engine: the execution surface of the port, one
``EngineConfig(mode=...)`` over ``simulate``, ``stale-psum``, ``ssp`` and
``sync``.

    from repro_torch.engine import EngineConfig, build_engine, Trainer

    engine = build_engine(mlp.loss_fn, paper_default("adam"),
                          EngineConfig(mode="stale-psum", num_workers=8,
                                       s=16, kernels="on",
                                       compress="topk:0.1",
                                       lr_scale="inverse"))
    result = Trainer(engine).run(batches, steps=1000, params=params,
                                 eval_fn=acc, eval_every=25, target=0.85)

Side concerns hang off the hook surface: ``CoherenceHook`` (coherence
monitor, gated staleness, live Theorem-1 signals), ``CheckpointHook``,
``TraceRecorderHook`` and the ``StdoutSink``/``JSONLinesSink`` log sinks.
"""
from repro_torch.engine.api import (
    MODES,
    Engine,
    EngineConfig,
    EngineState,
    build_engine,
)
from repro_torch.engine.hooks import (
    CheckpointHook,
    CoherenceHook,
    JSONLinesSink,
    StdoutSink,
    TraceRecorderHook,
)
from repro_torch.engine.plan import (
    Plan,
    build,
    make_train_engine,
    plan_decode,
    plan_prefill,
)
from repro_torch.engine.trainer import Hook, StepContext, Trainer, TrainResult
