from repro_torch.optim.sgd import sgd_init, sgd_update  # noqa: F401
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import constant, step_decay, warmup_cosine  # noqa: F401
