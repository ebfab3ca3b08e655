"""The CUDA kernels on the card: each held exactly against its plain
version on the same device tensors, and the executor's Count path on a
GPU holder against the same directory served on the CPU. Marked
``cuda``; where no GPU is present every test skips (decided inside the
fixture, never at import). Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``."""
import numpy as np
import pytest
import torch

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.storage.holder import Holder

pytestmark = pytest.mark.cuda

OPS = ("and", "or", "xor", "andnot")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(7)


def _rand(gen, *shape):
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (1, 192), (7, 32767),
                                   (64, 32768), (33,), (5, 0)])
@pytest.mark.parametrize("op", OPS)
def test_count_op_rows_equals_plain(gen, shape, op):
    a, b = _rand(gen, *shape), _rand(gen, *shape)
    assert torch.equal(kernels.count_op_rows(a, b, op),
                       kernels.count_op_rows_plain(a, b, op))


@pytest.mark.parametrize("fill", [0, -1, -2**31, None])
def test_count_rows_equals_plain(gen, fill):
    m = (_rand(gen, 7, 4097) if fill is None
         else torch.full((7, 4097), fill, dtype=torch.int32, device="cuda"))
    assert torch.equal(kernels.count_rows(m), kernels.count_rows_plain(m))


def test_misaligned_operands(gen):
    base = _rand(gen, 7 * 100 + 3)
    a = base[1:701].view(7, 100)   # 4-byte offset from 16-byte alignment
    b = base[3:703].view(7, 100)   # a different offset again
    for op in OPS:
        assert torch.equal(kernels.count_op_rows(a, b, op),
                           kernels.count_op_rows_plain(a, b, op))


def test_launch_counters_count_launches_only(gen):
    kernels.reset_launches()
    a = _rand(gen, 3, 64)
    kernels.count_rows(a)
    kernels.count_op_rows(a, a, "and")
    kernels.count_rows(a[:0])  # no rows: nothing launches
    assert kernels.launches == {"count_op_rows": 1, "count_rows": 1}


def test_executor_on_gpu_matches_cpu(gen, tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "d")
    h = Holder(path, device="cpu").open()
    view = h.create_index("i").create_frame("f").create_view_if_not_exists(
        "standard")
    for s in (0, 2, 3):
        cols = rng.integers(0, SLICE_WIDTH, 300000) + s * SLICE_WIDTH
        rows = rng.integers(0, 3, len(cols))
        view.create_fragment_if_not_exists(s).import_bits(rows, cols)
    h.close()
    queries = [
        'Count(Bitmap(frame="f", rowID=0))',
        'Count(Intersect(Bitmap(frame="f", rowID=0), '
        'Bitmap(frame="f", rowID=1)))',
        'Count(Xor(Bitmap(frame="f", rowID=2), Union('
        'Bitmap(frame="f", rowID=0), Bitmap(frame="f", rowID=1))))',
    ]
    results = {}
    for device in ("cpu", "cuda"):
        h = Holder(path, device=device).open()
        ex = Executor(h)
        kernels.reset_launches()
        for p in ("serial", "batched"):
            ex._force_path = p
            results[(device, p)] = [ex.execute("i", q)[0] for q in queries]
        if device == "cuda":
            assert kernels.launches["count_rows"] > 0
            assert kernels.launches["count_op_rows"] > 0
        h.close()
    assert len(set(map(tuple, results.values()))) == 1
