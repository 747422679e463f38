from repro_torch.models.build import (  # noqa: F401
    Model,
    ShapeDtype,
    batch_logical_axes,
    build_model,
    compute_params,
    input_specs,
    load_jax_params,
    make_concrete_batch,
)
