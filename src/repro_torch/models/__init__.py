from repro_torch.models.build import (  # noqa: F401
    Model,
    build_model,
    compute_params,
    load_jax_params,
)
