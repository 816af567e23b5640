from repro_torch.optim.optimizers import (
    Optimizer,
    adagrad,
    adam,
    get_optimizer,
    lr_at,
    make_sgd_update_fn,
    make_stochastic_update_fn,
    momentum,
    paper_default,
    rmsprop,
    sgd,
    value_and_grad,
)
from repro_torch.optim import schedules
