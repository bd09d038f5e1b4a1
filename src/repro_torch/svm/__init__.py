from repro_torch.svm.linear import LinearSVM, svm_objective  # noqa: F401
from repro_torch.svm.sparse import (  # noqa: F401
    CSRBatch,
    csr_to_dense,
    pack_csr_batch,
    pad_csr,
)
