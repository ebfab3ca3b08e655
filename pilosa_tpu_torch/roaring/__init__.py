"""Host-side roaring codec — the at-rest interchange format shared with
pilosa_tpu (roaring/roaring.go:560-738): files decode straight into a
fragment's column window (``parse_header``, ``fill_window``, the op log
through ``parse_ops``/``final_ops``) or container by container through
``LazyReader``; dense 2^16-bit blocks encode back choosing the cheapest
container type per block."""
from pilosa_tpu_torch.roaring.codec import (  # noqa: F401
    OP_ADD,
    OP_REMOVE,
    op_record,
    read_ops,
    serialize,
)
