from repro_torch.data.pipeline import (  # noqa: F401
    Prefetcher,
    SyntheticTokens,
    make_train_iterator,
)
