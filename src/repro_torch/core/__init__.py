"""LIRS — the paper's primary contribution (copies of ``repro.core``).

- location:   Data-Format-Aware Location Generator (offset tables)
- assignment: random assignment tables (explicit + O(1) Feistel)
- shuffler:   LIRS (instance / page-aware) + BMF + TFIP baselines
- readpath:   ReadPathConfig / build_data_plane (direct and tiered paths)
- pipeline:   prefetching input pipeline with Eq.1 time accounting
"""
from repro_torch.core.assignment import FeistelAssignment, TableAssignment  # noqa: F401
from repro_torch.core.location import LocationGenerator  # noqa: F401
from repro_torch.core.pipeline import InputPipeline, store_fetch_fn  # noqa: F401
from repro_torch.core.readpath import (  # noqa: F401
    ReadPathConfig,
    batch_iter_fn_of,
    build_data_plane,
    close_data_plane,
)
from repro_torch.core.shuffler import (  # noqa: F401
    BMFShuffler,
    LIRSShuffler,
    TFIPShuffler,
)
