from repro_torch.train.step import (  # noqa: F401
    TrainState,
    init_state,
    make_eval_step,
    make_train_step,
    run_timed_step,
)
