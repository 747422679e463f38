from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_with_warmup,
    linear_with_warmup,
)
