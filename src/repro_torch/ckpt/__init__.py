from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CKPT_FORMAT,
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
