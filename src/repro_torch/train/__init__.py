from repro_torch.train.step import (  # noqa: F401
    TrainState,
    abstract_state,
    init_state,
    make_eval_step,
    make_pipeline_train_step,
    make_sharded_train_step,
    make_train_step,
    run_timed_step,
)
