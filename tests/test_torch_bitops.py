"""Port parity: the count kernels' plain versions (what the wrappers run
on the CPU) against pilosa_tpu's bitops and its Pallas kernels in
interpret mode, on the same seeded words. Counts are integers, so every
comparison is exact (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitops as jbitops
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.ops import bitops, kernels

OPS = ("and", "or", "xor", "andnot")
_J_COUNT = {"and": jbitops.count_and, "or": jbitops.count_or,
            "xor": jbitops.count_xor, "andnot": jbitops.count_andnot}
_NP_OP = {"and": np.bitwise_and, "or": np.bitwise_or,
          "xor": np.bitwise_xor, "andnot": lambda a, b: a & ~b}


def _words(kind, shape, seed):
    """uint32 words of one edge-case kind."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64
                            ).astype(np.uint32)
    if kind == "zeros":
        return np.zeros(shape, np.uint32)
    if kind == "ones":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    if kind == "bit31":
        return np.full(shape, 0x80000000, np.uint32)
    if kind == "sparse":
        return (rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                & rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                & rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                ).astype(np.uint32)
    raise ValueError(kind)


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


KINDS = ("random", "zeros", "ones", "bit31", "sparse")
# (S, W): W not a multiple of 128 or of 4, S not a multiple of 8, 1-D.
SHAPES = ((8, 512), (7, 192), (1, 3), (12, 1), (3, 4097), (256,), (1,))


def test_popcount32_every_bit_pattern_class():
    rng = np.random.default_rng(0)
    w = np.concatenate([
        rng.integers(0, 1 << 32, size=4096, dtype=np.uint64
                     ).astype(np.uint32),
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF,
                  0xFFFF0000, 0x0000FFFF, 0xAAAAAAAA, 0x55555555],
                 np.uint32)])
    got = kernels.popcount32(_t(w)).numpy()
    assert got.dtype == np.int32
    assert (got == np.bitwise_count(w)).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", OPS)
def test_count_op_matches_jax_bitops(op, kind, shape):
    a = _words(kind, shape, 1)
    b = _words("random", shape, 2)
    got = int(bitops.count_op(op, _t(a), _t(b)))
    assert got == int(_J_COUNT[op](jnp.asarray(a), jnp.asarray(b)))
    assert got == int(np.bitwise_count(_NP_OP[op](a, b)).sum())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_count_and_matches_pallas_interpret(kind, shape):
    a = _words(kind, shape, 3)
    b = _words(kind, shape, 4)
    want = int(pk.count_and(jnp.asarray(a), jnp.asarray(b)))
    assert int(bitops.count_and(_t(a), _t(b))) == want


@pytest.mark.parametrize("shape", [s for s in SHAPES if len(s) == 2])
@pytest.mark.parametrize("kind", KINDS)
def test_count_rows_matches_pallas_and_bitops(kind, shape):
    m = _words(kind, shape, 5)
    got = bitops.count_rows(_t(m))
    assert got.dtype == torch.int32 and got.shape == shape[:1]
    assert (got.numpy() == np.asarray(pk.count_rows(jnp.asarray(m)))).all()
    assert (got.numpy()
            == np.asarray(jbitops.count_rows(jnp.asarray(m)))).all()


@pytest.mark.parametrize("op", OPS)
def test_count_op_rows_per_row(op):
    a, b = _words("random", (7, 192), 6), _words("sparse", (7, 192), 7)
    got = bitops.count_op_rows(_t(a), _t(b), op)
    assert got.dtype == torch.int32
    assert (got.numpy() == np.bitwise_count(_NP_OP[op](a, b)).sum(axis=1)
            ).all()


def test_count_over_one_dim_row():
    a = _words("random", (32768,), 8)
    assert int(bitops.count(_t(a))) == int(jbitops.count(jnp.asarray(a)))


@pytest.mark.parametrize("op", OPS)
def test_pair_ops_match_jax(op):
    a, b = _words("random", (4, 96), 9), _words("bit31", (4, 96), 10)
    fn = bitops.PAIR_OPS[op]
    jfn = {"and": jbitops.bitmap_and, "or": jbitops.bitmap_or,
           "xor": jbitops.bitmap_xor, "andnot": jbitops.bitmap_andnot}[op]
    got = fn(_t(a), _t(b)).numpy().view(np.uint32)
    assert (got == np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))).all()


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    kernels.reset_launches()
    a = _t(_words("random", (3, 64), 11))
    assert torch.equal(kernels.count_rows(a), kernels.count_rows_plain(a))
    assert torch.equal(kernels.count_op_rows(a, a, "xor"),
                       torch.zeros(3, dtype=torch.int32))
    assert kernels.launches == {"count_op_rows": 0, "count_rows": 0}


@pytest.mark.parametrize("bad", [
    lambda a: (a.to(torch.int64), a.to(torch.int64)),     # dtype
    lambda a: (a, a[:, :32].contiguous()),                 # shape
    lambda a: (a.t(), a.t()),                               # contiguity
    lambda a: (a.to("meta"), a.to("meta")),                # no kernel
])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    x, y = bad(_t(_words("random", (4, 64), 12)))
    with pytest.raises((TypeError, ValueError)):
        kernels.count_op_rows(x, y, "and")


def test_unknown_op_rejected():
    a = _t(_words("random", (2, 8), 13))
    with pytest.raises(ValueError):
        kernels.count_op_rows(a, a, "nand")
