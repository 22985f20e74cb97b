from tpu3dssf_torch.serialization.codes import (
    SERIALIZATION_ORDERS,
    hilbert_encode,
    morton_encode,
    pack_cell_keys,
    serialization_keys,
)
from tpu3dssf_torch.serialization.partition import (
    argsort_lex,
    gather_rows,
    inverse_permutation,
    permutation_gather,
    segment_sum,
)

__all__ = [
    "morton_encode",
    "hilbert_encode",
    "serialization_keys",
    "pack_cell_keys",
    "SERIALIZATION_ORDERS",
    "argsort_lex",
    "inverse_permutation",
    "permutation_gather",
    "gather_rows",
    "segment_sum",
]
