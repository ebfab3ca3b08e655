"""pilosa_tpu_torch — the PyTorch/CUDA port of pilosa_tpu.

The same PQL engine over 2^20-column bitmap slices, with device words
held in ``torch`` tensors on an NVIDIA GPU and the count reductions run
by hand-written CUDA kernels (``csrc/``). It reads and writes the same
reference roaring data directory as ``pilosa_tpu``, which stays the
reference implementation; this package imports nothing from it.

Layout (module names mirror ``pilosa_tpu``)
------
- ``ops/``      bitwise algebra, popcount plain versions, kernel wrappers
- ``csrc/``     CUDA C++ kernel sources, built with nvcc at first use
- ``roaring/``  host-side roaring on-disk codec (numpy)
- ``storage/``  fragment / view / frame / index / holder hierarchy
- ``pql/``      PQL scanner / parser / AST
- ``executor``  Count/SetBit/ClearBit over Bitmap trees, serial and batched

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU; without a GPU they raise instead of falling back.
"""

# The unit of column sharding. One slice covers 2^20 columns
# (ref: fragment.go:50 SliceWidth = 1048576).
SLICE_WIDTH = 1 << 20

# Device words are 32 bits, as in pilosa_tpu; the host/disk format stays
# 64-bit roaring. A little-endian uint64[16384] buffer viewed as
# int32[32768] is bit-for-bit the device layout, so no repacking happens
# at the host-to-device boundary. Words are held as int32 because torch
# has no popcount and lacks ``~``/``>>`` for uint32.
WORD_BITS = 32
WORDS_PER_SLICE = SLICE_WIDTH // WORD_BITS  # 32768

__version__ = "0.1.0"
