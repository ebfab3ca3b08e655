"""Port parity for the storage layer: the roaring codec byte for byte,
and one data directory (and one backup archive) read and written by
both packages. Closes one package's holder before the other opens the
directory — each takes an exclusive flock on it."""
import io
import os

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.roaring import codec as jcodec
from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu.storage.holder import Holder as JHolder
from pilosa_tpu_torch import errors as terr
from pilosa_tpu_torch.roaring import codec as tcodec
from pilosa_tpu_torch.storage.fragment import Fragment as TFragment
from pilosa_tpu_torch.storage.holder import Holder as THolder
from pilosa_tpu_torch.storage.index import Index as TIndex


# ------------------------------------------------------------------ codec

def _block(kind, rng):
    b = np.zeros(1024, np.uint64)
    if kind == "dense":
        b[:] = rng.integers(0, 1 << 64, 1024, dtype=np.uint64)
    elif kind == "array":
        b[rng.integers(0, 1024, 40)] = np.uint64(1) << np.uint64(7)
    elif kind == "run":
        b[10:500] = np.uint64(0xFFFFFFFFFFFFFFFF)
    elif kind == "array4096":     # exactly at the array limit
        b[:64] = np.uint64(0xFFFFFFFFFFFFFFFF)
    elif kind == "alternating":   # 2048 bits, 2048 runs: array wins
        b[:64] = np.uint64(0x5555555555555555)
    elif kind == "many_runs":     # > 4096 bits, > 2048 runs: bitmap
        b[:130] = np.uint64(0x5555555555555555)
    elif kind == "bit63_chain":   # runs crossing word boundaries
        b[::3] = np.uint64(1 << 63)
        b[1::3] = np.uint64(1)
    return b


BLOCK_KINDS = ("dense", "array", "run", "array4096", "alternating",
               "many_runs", "bit63_chain", "empty")


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_serialize_is_byte_identical(kind):
    rng = np.random.default_rng(1)
    blocks = {3: _block(kind, rng), 40: _block("dense", rng),
              17: _block("array", rng)}
    assert tcodec.serialize(blocks) == jcodec.serialize(blocks)


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_deserialize_with_op_log_matches(kind, tmp_path):
    """A fragment's full load (header, containers into the column
    window, op-log replay) against the reference decoder: the same rows
    and words; a torn tail keeps the valid prefix and is rewritten."""
    rng = np.random.default_rng(2)
    data = jcodec.serialize({5: _block(kind, rng), 9: _block("run", rng)})
    ops = [(0, 5 << 16 | 3), (1, 9 << 16 | 700), (0, 77 << 16),
           (1, 5 << 16 | 3), (0, 5 << 16 | 3)]
    tail = b"".join(jcodec.op_record(t, v) for t, v in ops)
    for torn in (b"", b"\x01\x02\x03"):
        jb, jn, jt = jcodec.deserialize(data + tail + torn)
        path = str(tmp_path / f"frag{len(torn)}")
        with open(path, "wb") as f:
            f.write(data + tail + torn)
        frag = TFragment(path, "i", "f", "standard", 0, device="cpu").open()
        try:
            frag.count()  # faults the fragment in: the full load
            assert frag.op_n == (0 if jt else jn)
            rows = {k // 16 for k in jb if jb[k].any()}
            assert set(frag.rows(nonempty=True)) == rows
            for r in rows:
                want = np.zeros(16 * 1024, np.uint64)
                for k in jb:
                    if k // 16 == r:
                        want[(k % 16) * 1024:(k % 16 + 1) * 1024] = jb[k]
                assert (frag.row_words(r) == want).all()
        finally:
            frag.close()
        with open(path, "rb") as f:
            rb, rn, rt = jcodec.deserialize(f.read())
        assert (rn, rt) == ((0, False) if jt else (jn, False))
        assert {k for k in rb if rb[k].any()} == {k for k in jb
                                                  if jb[k].any()}
        for k in rb:
            assert (rb[k] == jb.get(k, 0)).all()


def test_empty_and_all_zero_blocks_serialize_as_reference():
    zero = np.zeros((2, 1024), np.uint64)
    want = jcodec.serialize({})
    assert tcodec.serialize({}) == want
    assert tcodec.serialize_arrays(np.zeros(0, np.uint64),
                                   np.zeros((0, 1024), np.uint64)) == want
    assert tcodec.serialize_arrays(np.array([1, 2], np.uint64), zero) == want


def test_op_records_match_reference_encoder():
    typs = np.array([0, 1, 0], np.uint8)
    vals = np.array([0, 1 << 40, (1 << 64) - 1], np.uint64)
    assert tcodec.op_records(typs, vals) == b"".join(
        jcodec.op_record(int(t), int(v)) for t, v in zip(typs, vals))
    assert list(tcodec.read_ops(tcodec.op_records(typs, vals))) == [
        (0, 0), (1, 1 << 40), (0, (1 << 64) - 1)]


# ------------------------------------------------- shared data directory

def _bits(rng, slices, rows, n):
    r = rng.integers(0, rows, n).astype(np.uint64)
    c = np.concatenate([
        s * SLICE_WIDTH + rng.integers(0, SLICE_WIDTH, n // len(slices))
        for s in slices]).astype(np.uint64)
    return r[: len(c)], c


def _snapshot_state(holder):
    """{(view, slice): {row: uint64 words}} of frame f in index i."""
    out = {}
    frame = holder.index("i").frame("f")
    for vname, view in frame.views.items():
        for s, frag in view.fragments.items():
            out[(vname, s)] = {r: frag.row_words(r) for r in frag.rows()
                               if frag.row_count(r)}
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert sorted(a[key]) == sorted(b[key]), key
        for r in a[key]:
            assert (a[key][r] == b[key][r]).all(), (key, r)


def test_directory_written_by_reference_reads_back_in_port(tmp_path):
    path = str(tmp_path / "d")
    rng = np.random.default_rng(3)
    jh = JHolder(path).open()
    frame = jh.create_index("i").create_frame("f")
    rows, cols = _bits(rng, [0, 1, 3], 5, 30000)
    frame.import_bits(rows, cols)           # snapshotted import
    frag = frame.view("standard").fragment(1)
    frag.set_bit(9, SLICE_WIDTH + 12345)    # op-log tail, not snapshotted
    frag.clear_bit(int(rows[len(rows) // 3 + 1]),
                   int(cols[len(rows) // 3 + 1]))
    frame.view("standard").fragment(3).snapshot()
    want = _snapshot_state(jh)
    jh.close()

    th = THolder(path, device="cpu").open()
    _assert_same(_snapshot_state(th), want)
    tf = th.index("i").frame("f").view("standard").fragment(1)
    assert tf.op_n == 2 and tf.count() == sum(
        int(np.bitwise_count(w).sum()) for w in want[("standard", 1)].values())
    th.close()


def test_directory_written_by_port_reads_back_in_reference(tmp_path):
    path = str(tmp_path / "d")
    rng = np.random.default_rng(4)
    th = THolder(path, device="cpu").open()
    frame = th.create_index("i").create_frame("f")
    view = frame.create_view_if_not_exists("standard")
    rows, cols = _bits(rng, [0, 2], 4, 20000)
    for s in (0, 2):
        sel = cols // SLICE_WIDTH == s
        view.create_fragment_if_not_exists(s).import_bits(rows[sel],
                                                          cols[sel])
    frag = view.fragment(2)
    assert frag.set_bit(7, 2 * SLICE_WIDTH + 5)
    assert not frag.set_bit(7, 2 * SLICE_WIDTH + 5)
    assert frag.clear_bit(int(rows[-1]), int(cols[-1]))
    frag.import_bits([1, 1], [2 * SLICE_WIDTH, 2 * SLICE_WIDTH + 64])
    want = _snapshot_state(th)
    want_cache = frag.rows(nonempty=True)
    th.close()

    jh = JHolder(path).open()
    got = _snapshot_state(jh)
    _assert_same(got, want)
    jfrag = jh.index("i").frame("f").view("standard").fragment(2)
    assert jfrag.op_n > 0  # the port's writes reached the op log
    assert jfrag.cache.ids() == want_cache  # rank-cache sidecar
    jh.close()


def test_port_recovers_a_torn_op_log_tail(tmp_path):
    path = str(tmp_path / "frag")
    f = TFragment(path, "i", "f", "standard", 0, device="cpu").open()
    f.set_bit(1, 10)
    f.set_bit(1, 11)
    f.close()
    with open(path, "ab") as fh:
        fh.write(b"\x00\x01\x02")
    f = TFragment(path, "i", "f", "standard", 0, device="cpu").open()
    # A lazy read applies the valid prefix; the first fault-in rewrites
    # the torn tail away by a snapshot.
    assert f.row_count(1) == 2 and f.count() == 2 and f.op_n == 0
    f.close()
    jf = JFragment(path, "i", "f", "standard", 0).open()
    assert jf.row_count(1) == 2
    jf.close()


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_backup_archive_round_trips_between_packages(tmp_path, direction):
    rng = np.random.default_rng(5)
    rows, cols = _bits(rng, [3], 6, 40000)
    cls_src, cls_dst = ((JFragment, TFragment)
                        if direction == "reference_to_port"
                        else (TFragment, JFragment))
    src = cls_src(str(tmp_path / "src"), "i", "f", "standard", 3).open()
    src.import_bits(rows, cols)
    src.set_bit(2, 3 * SLICE_WIDTH + 1)
    buf = io.BytesIO()
    src.write_to(buf)
    buf.seek(0)
    dst = cls_dst(str(tmp_path / "dst"), "i", "f", "standard", 3).open()
    dst.read_from(buf)
    for r in range(6):
        assert (dst.row_words(r) == src.row_words(r)).all()
        assert dst.row_count(r) == src.row_count(r)
    src.close()
    dst.close()
    # The restored file alone (reopened) holds the same bits.
    again = cls_dst(str(tmp_path / "dst"), "i", "f", "standard", 3).open()
    assert again.count() == int(sum(again.row_count(r) for r in range(6)))
    assert again.count() == len(set(zip(rows.tolist(), cols.tolist())) |
                                {(2, 3 * SLICE_WIDTH + 1)})
    again.close()


def test_holders_exclude_each_other(tmp_path):
    path = str(tmp_path / "d")
    jh = JHolder(path).open()
    with pytest.raises(terr.ErrHolderLocked):
        THolder(path, device="cpu").open()
    jh.close()
    th = THolder(path, device="cpu").open()
    from pilosa_tpu import errors as jerr
    with pytest.raises(jerr.ErrHolderLocked):
        JHolder(path).open()
    th.close()
    JHolder(path).open().close()


def test_standalone_port_fragment_refuses_a_locked_holder_tree(tmp_path):
    path = str(tmp_path / "d")
    jh = JHolder(path).open()
    jh.create_index("i").create_frame("f").create_view_if_not_exists(
        "standard").create_fragment_if_not_exists(0)
    frag_path = os.path.join(path, "i", "f", "views", "standard",
                             "fragments", "0")
    with pytest.raises(terr.ErrFragmentLocked):
        TFragment(frag_path, "i", "f", "standard", 0, device="cpu").open()
    jh.close()
    TFragment(frag_path, "i", "f", "standard", 0, device="cpu").open().close()


def test_meta_files_round_trip(tmp_path):
    path = str(tmp_path / "d")
    th = THolder(path, device="cpu").open()
    idx = th.create_index("i", column_label="col")
    from pilosa_tpu_torch.storage.frame import FrameOptions
    idx.create_frame("f", FrameOptions(row_label="row", inverse_enabled=True,
                                       cache_type="lru", cache_size=77))
    with pytest.raises(terr.ErrFrameExists):
        idx.create_frame("f")
    th.close()
    jh = JHolder(path).open()
    jidx = jh.index("i")
    jf = jidx.frame("f")
    assert (jidx.column_label, jf.row_label, jf.inverse_enabled,
            jf.cache_type, jf.cache_size) == ("col", "row", True, "lru", 77)
    jidx.create_frame("g")
    jh.close()
    ti = TIndex(os.path.join(path, "i"), "i", device="cpu",
                holder_locked=True).open()
    assert sorted(ti.frames) == ["f", "g"] and ti.column_label == "col"
    ti.close()
