"""repro_torch.engine: the execution surface of the port.

    from repro_torch.engine import EngineConfig, build_engine, Trainer

    engine = build_engine(mlp.loss_fn, paper_default("adam"),
                          EngineConfig(mode="simulate", num_workers=8, s=16,
                                       kernels="on"))
    result = Trainer(engine).run(batches, steps=1000, params=params,
                                 eval_fn=acc, eval_every=25, target=0.85)
"""
from repro_torch.engine.api import (
    MODES,
    Engine,
    EngineConfig,
    EngineState,
    build_engine,
)
from repro_torch.engine.trainer import Hook, StepContext, Trainer, TrainResult
