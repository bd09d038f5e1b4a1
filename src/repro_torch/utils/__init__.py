"""Small helpers shared across the port."""
from repro_torch.utils.tree import (  # noqa: F401
    map_with_path,
    path_str,
    tree_bytes,
    tree_param_count,
)
