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
    assert torch.equal(kernels.count_and_rows(a, a[0]),
                       kernels.count_and_rows_plain(a, a[0]))
    assert torch.equal(kernels.count_and_rows_stacks([a, a], a),
                       torch.stack([kernels.count_rows_plain(a)] * 2))
    assert torch.equal(kernels.count_op_pairs([a, a], [a, a], "xor"),
                       torch.zeros((2, 3), dtype=torch.int32))
    assert torch.equal(kernels.count_and_rows_multi([a], [a, a]),
                       torch.stack([kernels.count_rows_plain(a)[None]] * 2))
    pos = torch.tensor([0, 31, 40], dtype=torch.int32)
    offs = torch.tensor([0, 3], dtype=torch.int32)
    assert kernels.container_and_counts(
        "array_array", (pos, offs), (pos, offs)).tolist() == [3]
    assert kernels.launches == {"count_op_rows": 0, "count_rows": 0,
                                "count_and_rows": 0, "count_op_pairs": 0,
                                "count_and_rows_multi": 0,
                                "container_and_counts": 0,
                                "ingest_classify": 0}


def test_cpu_wrappers_count_no_regime():
    kernels.reset_launches()
    a = _t(_words("random", (11, 32768), 32))
    kernels.count_rows(a)
    kernels.count_op_rows(a[0], a[1], "and")
    kernels.count_and_rows(a, a[0])
    assert all(n == 0 for split in kernels.regime_launches.values()
               for n in split.values())
    assert set(kernels.regime_launches) == {"count_op_rows", "count_rows",
                                            "count_and_rows"}
    assert all(tuple(split) == kernels.REGIMES
               for split in kernels.regime_launches.values())


# The shapes of the CUDA kernels' narrow and split regimes: a serial
# launch's one row and 11 rows, narrow windows, widths that are not a
# multiple of 128 (or of 4).
REGIME_SHAPES = ((1, 32768), (1, 2049), (11, 32768), (11, 1025),
                 (300, 128), (33, 127), (9, 129), (2, 5))


@pytest.mark.parametrize("shape", REGIME_SHAPES)
@pytest.mark.parametrize("kind", ("random", "ones", "bit31"))
def test_regime_shapes_match_pallas_interpret(kind, shape):
    a = _words(kind, shape, 33)
    b = _words("random", shape, 34)
    want = int(pk.count_and(jnp.asarray(a), jnp.asarray(b)))
    assert int(bitops.count_and(_t(a), _t(b))) == want
    got = bitops.count_rows(_t(a))
    assert (got.numpy() == np.asarray(pk.count_rows(jnp.asarray(a)))).all()
    got = bitops.count_and_rows(_t(a), _t(b[0]))
    assert (got.numpy() == np.asarray(pk.count_and_rows(
        jnp.asarray(a), jnp.asarray(b[0])))).all()


@pytest.mark.parametrize("width", [128, 129, 2049, 32768])
@pytest.mark.parametrize("op", OPS)
def test_one_dim_serial_rows_match_jax_bitops(op, width):
    """The serial path's 1-D slice segments, one row a launch on the
    card."""
    a, b = _words("random", (width,), 35), _words("sparse", (width,), 36)
    got = int(bitops.count_op(op, _t(a), _t(b)))
    assert got == int(_J_COUNT[op](jnp.asarray(a), jnp.asarray(b)))


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


# ------------------------------------------------------- count_and_rows

# (R, W): R not a multiple of 8, W ragged (not a multiple of 4 or 128).
AND_ROWS_SHAPES = ((8, 512), (7, 192), (1, 3), (12, 1), (3, 4097),
                   (9, 130), (0, 64))


@pytest.mark.parametrize("shape", AND_ROWS_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_count_and_rows_matches_pallas_and_bitops(kind, shape):
    m = _words(kind, shape, 14)
    filt = _words("random" if kind != "ones" else "ones", shape[1:], 15)
    got = bitops.count_and_rows(_t(m), _t(filt))
    assert got.dtype == torch.int32 and got.shape == shape[:1]
    want = np.asarray(jbitops.count_and_rows(jnp.asarray(m),
                                             jnp.asarray(filt)))
    assert (got.numpy() == want).all()
    if shape[0]:
        assert (got.numpy() == np.asarray(pk.count_and_rows(
            jnp.asarray(m), jnp.asarray(filt)))).all()
    assert (got.numpy() == np.bitwise_count(m & filt).sum(axis=1)).all()


@pytest.mark.parametrize("n_rows", [0, 1, 7, 9])
@pytest.mark.parametrize("shape", [(6, 192), (1, 3), (5, 4097)])
def test_count_and_rows_stacks_matches_reference_per_slice(n_rows, shape):
    """Stacked form: out[r, s] is pilosa_tpu's count_and_rows of
    candidate r's slice s against the filter's slice s."""
    kinds = ("random", "bit31", "ones", "sparse", "zeros")
    rows = [_words(kinds[r % len(kinds)], shape, 20 + r)
            for r in range(n_rows)]
    filt = _words("random", shape, 19)
    got = bitops.count_and_rows_stacks([_t(r) for r in rows], _t(filt))
    assert got.dtype == torch.int32 and got.shape == (n_rows, shape[0])
    for r, m in enumerate(rows):
        for s in range(shape[0]):
            want = int(np.asarray(jbitops.count_and_rows(
                jnp.asarray(m[s:s + 1]), jnp.asarray(filt[s])))[0])
            assert int(got[r, s]) == want


@pytest.mark.parametrize("bad", [
    lambda m, f: ([m.to(torch.int64)], f),               # dtype
    lambda m, f: ([m[:, :32].contiguous()], f),           # shape
    lambda m, f: ([m.t().contiguous().t()], f),           # contiguity
    lambda m, f: ([m.to("meta")], f.to("meta")),          # no kernel
    lambda m, f: ([m], f[0]),                             # filter rank
])
def test_count_and_rows_stacks_rejects_what_the_kernel_does_not_take(bad):
    m = _t(_words("random", (4, 64), 16))
    rows, f = bad(m, _t(_words("random", (4, 64), 17)))
    with pytest.raises((TypeError, ValueError)):
        kernels.count_and_rows_stacks(rows, f)


@pytest.mark.parametrize("bad", [
    lambda m, f: (m, f[:32]),                             # width
    lambda m, f: (m[0], f),                               # m rank
    lambda m, f: (m.to(torch.int64), f),                  # dtype
    lambda m, f: (m.to("meta"), f.to("meta")),            # no kernel
])
def test_count_and_rows_rejects_what_the_kernel_does_not_take(bad):
    m = _t(_words("random", (4, 64), 18))
    x, f = bad(m, _t(_words("random", (64,), 19)))
    with pytest.raises((TypeError, ValueError)):
        kernels.count_and_rows(x, f)
