from repro_torch.data.synthetic import (  # noqa: F401
    DatasetMeta,
    decode_dense,
    decode_sparse,
    decode_tokens,
    make_classification_dataset,
    make_token_dataset,
)
