"""Streaming bulk ingest — one request carries millions of bits
(counterpart of the single-node path of pilosa_tpu/ingest/pipeline.py).

A (row, column[, timestamp]) batch, or a (column, value) batch of a BSI
field, lands in three steps:

1. **Partition and sort**: one vectorized pass splits the batch by
   (view, slice) — the standard view, the inverse view of an
   inverse-enabled frame (rows and columns swapped) and each timestamped
   bit's time-quantum views — and sorts each group by (row, column),
   deduplicated.
2. **Classify in one pass**: per group, the registry's ``classify`` cell
   (ops/ingest.py) gives each row's cardinality and run starts from the
   sorted position stream; on a ``cuda`` holder that is the hand kernel
   ``ingest_classify`` on the card. The roaring thresholds then pick
   ARRAY, RUN or DENSE per row, and the ``build.<fmt>`` cells build the
   rows' containers from the batch's positions.
3. **Install**: ``Fragment.install_batch`` appends the group to the op
   log (one fsync) or snapshots, scatters it, bumps the epoch once, and
   seeds the containers of the rows the batch created, so they serve
   compressed with no conversion.

The classify pass of a group finishes before anything of that group
installs: a failing pass never half-installs it. A batch over
``max_batch_bits`` is refused (413) before any work.

On a cluster (``cluster`` and ``client`` given) the node a batch
reaches is its coordinator (ref: pilosa_tpu ingest/pipeline.py:101-354):
it splits the batch by slice and sends each slice's part to every owner
of the slice as a ``?slice=`` leg (``InternalClient.ingest_slice``, the
binary frame; values through ``import_values``), ``FANOUT_WIDTH`` slices
at a time, and acknowledges only when every leg of every slice did: a
DOWN owner fails the request, and nothing is hinted. A leg
(``local=True``) installs on its owner through the steps above. Under
an active trace a batch runs in an ``ingest.batch`` span and a values
batch in ``ingest.values`` (ref: pipeline.py:165, :213). The QoS gate,
failpoints and histograms wait for their own ports (ROADMAP Queue A 17b,
22).
"""
import threading
from datetime import datetime

import numpy as np

from pilosa_tpu_torch import SLICE_WIDTH, WORDS_PER_SLICE
from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch import time_quantum as tq
from pilosa_tpu_torch import tracing
from pilosa_tpu_torch.ops import bitops
from pilosa_tpu_torch.ops import containers as containers_mod
from pilosa_tpu_torch.ops import ingest as ingest_ops  # registers the cells
from pilosa_tpu_torch.storage.view import VIEW_INVERSE, VIEW_STANDARD
from pilosa_tpu_torch.utils import fanpool

# Per-request bit budget ([ingest] max-batch-bits).
DEFAULT_MAX_BATCH_BITS = 8_000_000
# Slice groups a coordinator posts at once (ref: pilosa_tpu
# pipeline.py:72): the fan pool never queues, so a window bounds the
# connections one batch opens.
FANOUT_WIDTH = 8

_FORMATS = (bitops.FMT_ARRAY, bitops.FMT_RUN, bitops.FMT_DENSE)


class IngestError(ValueError):
    """A caller-fault rejection; ``status`` is its HTTP status."""

    def __init__(self, message, status=400):
        super().__init__(message)
        self.status = status


def _u64(name, values):
    """Caller ids -> uint64; negative or non-integer ids are a 400."""
    try:
        return np.ascontiguousarray(values, dtype=np.uint64)
    except (ValueError, TypeError, OverflowError) as e:
        raise IngestError(f"invalid {name}: {e}")


def _i64(name, values):
    try:
        return np.ascontiguousarray(values, dtype=np.int64)
    except (ValueError, TypeError, OverflowError) as e:
        raise IngestError(f"invalid {name}: {e}")


class IngestPipeline:
    def __init__(self, holder, cluster=None, client=None,
                 max_batch_bits=DEFAULT_MAX_BATCH_BITS):
        self.holder = holder
        self.cluster = cluster
        self.client = client
        self.max_batch_bits = int(max_batch_bits)
        self._mu = threading.Lock()  # the counters only
        self._c = {"batches": 0, "bits": 0, "values": 0, "slices": 0,
                   "fanout_posts": 0, "pack_passes": 0, "errors": 0,
                   "rejected": 0, "seeded": dict.fromkeys(_FORMATS, 0)}
        self._pool = None  # the coordinator's fan pool, lazily

    def close(self):
        with self._mu:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()

    # ------------------------------------------------------------ entry

    def _too_large(self, n, what):
        if n > self.max_batch_bits:
            with self._mu:
                self._c["rejected"] += 1
            raise IngestError(
                f"batch of {n} {what} exceeds [ingest] max-batch-bits "
                f"({self.max_batch_bits})", status=413)

    def _run(self, fn, *args):
        try:
            return fn(*args)
        except IngestError:
            raise
        except Exception:
            with self._mu:
                self._c["errors"] += 1
            raise

    def ingest_bits(self, index_name, frame_name, rows, columns,
                    timestamps=None, local=False):
        """Ingest one (row, column[, timestamp]) batch; timestamps are
        epoch seconds, 0 for none. A coordinator fans it out; ``local``
        (an owner's leg, or one node) installs it here. -> {"accepted",
        "slices"}."""
        rows = _u64("rows", rows)
        columns = _u64("columns", columns)
        if len(rows) != len(columns):
            raise IngestError("row/column length mismatch")
        ts = None
        if timestamps is not None and len(timestamps):
            ts = _i64("timestamps", timestamps)
            if len(ts) != len(rows):
                raise IngestError("timestamp length mismatch")
            if not ts.any():
                ts = None
        self._too_large(len(rows), "bits")
        fr = self._frame(index_name, frame_name)
        if len(rows) == 0:
            return {"accepted": 0, "slices": 0}
        with tracing.span("ingest.batch", index=index_name,
                          frame=frame_name, bits=len(rows)):
            if self._is_coordinator(local):
                n_slices = self._run(self._fan_out_bits, index_name, fr,
                                     rows, columns, ts)
            else:
                n_slices = self._run(self._install_local, fr, rows,
                                     columns, ts)
        with self._mu:
            self._c["batches"] += 1
            self._c["bits"] += len(rows)
            self._c["slices"] += n_slices
        return {"accepted": int(len(rows)), "slices": int(n_slices)}

    def ingest_values(self, index_name, frame_name, field, columns,
                      values, local=False):
        """A BSI field's (column, value) batch, through the frame's
        ``import_value`` plane writer on each owner."""
        columns = _u64("columns", columns)
        values = _i64("values", values)
        if len(columns) != len(values):
            raise IngestError("column/value length mismatch")
        self._too_large(len(columns), "values")
        fr = self._frame(index_name, frame_name)
        fr.field(field)  # 400 before any work
        if len(columns) == 0:
            return {"accepted": 0, "slices": 0}

        def install():
            fr.import_value(field, columns.tolist(), values.tolist())
            return len(np.unique(columns // SLICE_WIDTH))

        with tracing.span("ingest.values", index=index_name,
                          frame=frame_name, values=len(columns)):
            if self._is_coordinator(local):
                n_slices = self._run(self._fan_out_values, index_name, fr,
                                     field, columns, values)
            else:
                n_slices = self._run(install)
        with self._mu:
            self._c["batches"] += 1
            self._c["values"] += len(columns)
            self._c["slices"] += n_slices
        return {"accepted": int(len(columns)), "slices": int(n_slices)}

    def _frame(self, index_name, frame_name):
        idx = self.holder.index(index_name)
        if idx is None:
            raise perr.ErrIndexNotFound()
        fr = idx.frame(frame_name)
        if fr is None:
            raise perr.ErrFrameNotFound()
        return fr

    # ------------------------------------------------------ coordinator

    def _is_coordinator(self, local):
        return (not local and self.cluster is not None
                and len(self.cluster.nodes) > 1 and self.client is not None)

    def _fan_groups(self, jobs):
        """Run the per-slice jobs on the fan pool, FANOUT_WIDTH at a
        time; wait for all, then raise the first failure: the batch is
        acknowledged only when every slice landed."""
        if len(jobs) == 1:
            jobs[0]()
            return
        with self._mu:
            if self._pool is None:
                self._pool = fanpool.FanoutPool(max_idle=FANOUT_WIDTH)
            pool = self._pool
        fanpool.run_all(pool, jobs, FANOUT_WIDTH)

    def _fan_out_bits(self, index_name, fr, rows, columns, ts):
        """-> the slice groups posted."""
        jobs = [lambda s=s, g=g: self._post_leg(
                    self.client.ingest_slice, self.cluster, index_name,
                    fr.name, s, rows[g], columns[g],
                    ts[g] if ts is not None else None)
                for s, g in self._slice_groups(columns)]
        self._fan_groups(jobs)
        return len(jobs)

    def _fan_out_values(self, index_name, fr, field, columns, values):
        jobs = [lambda s=s, g=g: self._post_leg(
                    self.client.import_values, self.cluster, index_name,
                    fr.name, s, field, columns[g].tolist(),
                    values[g].tolist())
                for s, g in self._slice_groups(columns)]
        self._fan_groups(jobs)
        return len(jobs)

    def _post_leg(self, post, *args):
        post(*args)
        with self._mu:
            self._c["fanout_posts"] += 1

    # ---------------------------------------------------------- install

    @staticmethod
    def _slice_groups(columns):
        """(slice, selector) groups of one batch."""
        slices = columns // SLICE_WIDTH
        order = np.argsort(slices)
        bounds = np.flatnonzero(np.diff(slices[order])) + 1
        for g in np.split(order, bounds):
            if len(g):
                yield int(slices[g[0]]), g

    def _install_local(self, fr, rows, columns, ts):
        """The frame's views as ``Frame.import_bits`` writes them; -> the
        (view, slice) groups installed."""
        n = self._install_view(fr, VIEW_STANDARD, rows, columns)
        if fr.inverse_enabled:
            n += self._install_view(fr, VIEW_INVERSE, columns, rows)
        if ts is not None:
            view_lists = {}  # timestamp -> its views, memoized
            groups = {}
            for i, t in enumerate(ts.tolist()):
                if t == 0:
                    continue
                views = view_lists.get(t)
                if views is None:
                    views = view_lists[t] = tq.views_by_time(
                        VIEW_STANDARD, datetime.fromtimestamp(t),
                        fr.time_quantum)
                for sub in views:
                    groups.setdefault(sub, []).append(i)
            for view_name, idxs in sorted(groups.items()):
                sel = np.asarray(idxs, dtype=np.int64)
                n += self._install_view(fr, view_name, rows[sel],
                                        columns[sel])
        return n

    def _install_view(self, fr, view_name, rows, columns):
        view = fr.create_view_if_not_exists(view_name)
        n = 0
        for slice_num, g in self._slice_groups(columns):
            n += 1
            frag = view.create_fragment_if_not_exists(slice_num)
            self._install_slice(frag, rows[g], columns[g])
        return n

    def _install_slice(self, frag, rows, columns):
        """One (view, slice) group: sort and dedupe, one classify pass,
        the rows' containers, then ``install_batch``. With the container
        tier off the group goes through ``import_bits`` (the same
        files)."""
        classify = bitops.ingest_kernel("classify")
        if classify is None or not containers_mod.enabled():
            frag.import_bits(rows, columns)
            return
        lcols = (columns % np.uint64(SLICE_WIDTH)).astype(np.int64)
        # One u64 key row·2^20 + column sorts by (row, column) while rows
        # are below 2^44; beyond, a two-key lexsort.
        if int(rows.max()) < (1 << 44):
            key = rows * np.uint64(SLICE_WIDTH) + lcols.astype(np.uint64)
            order = np.argsort(key)
            key = key[order]
            dup_tail = key[1:] == key[:-1]
        else:
            order = np.lexsort((lcols, rows))
            key = None
            dup_tail = ((rows[order][1:] == rows[order][:-1])
                        & (lcols[order][1:] == lcols[order][:-1]))
        rows, columns, lcols = rows[order], columns[order], lcols[order]
        if len(rows) > 1 and dup_tail.any():
            keep = np.concatenate(([True], ~dup_tail))
            rows, columns, lcols = rows[keep], columns[keep], lcols[keep]
            if key is not None:
                key = key[keep]
        starts = np.flatnonzero(
            np.concatenate(([True], rows[1:] != rows[:-1])))
        uniq_rows = rows[starts]
        bounds = np.append(starts, len(rows))
        rowidx = np.repeat(np.arange(len(uniq_rows), dtype=np.int32),
                           np.diff(bounds))
        counts, n_runs = classify(rowidx, lcols, len(uniq_rows),
                                  device=frag.device)
        with self._mu:
            self._c["pack_passes"] += 1
        fmts = ingest_ops.classify_formats(counts, n_runs)
        build = {f: bitops.ingest_kernel("build." + f) for f in _FORMATS}
        containers_by_row = {}
        counts_by_row = {}
        for i, rid in enumerate(uniq_rows.tolist()):
            fmt = str(fmts[i])
            containers_by_row[rid] = (fmt, build[fmt](
                lcols[bounds[i]:bounds[i + 1]], WORDS_PER_SLICE,
                device=frag.device))
            counts_by_row[rid] = int(counts[i])
        seeded = frag.install_batch(rows, columns, containers_by_row,
                                    counts_by_row, positions=key)
        if seeded:
            with self._mu:
                for fmt, n_fmt in seeded.items():
                    self._c["seeded"][fmt] += n_fmt

    # ---------------------------------------------------- observability

    def snapshot(self):
        """The ``ingest`` group of ``/debug/vars`` (the reference's
        keys)."""
        with self._mu:
            c = dict(self._c)
            c["seeded"] = dict(self._c["seeded"])
        return {
            "enabled": True,
            "maxBatchBits": self.max_batch_bits,
            "batchesTotal": c["batches"],
            "bitsTotal": c["bits"],
            "valuesTotal": c["values"],
            "sliceGroupsTotal": c["slices"],
            "fanoutPostsTotal": c["fanout_posts"],
            "packPassesTotal": c["pack_passes"],
            "containersSeeded": c["seeded"],
            "errorsTotal": c["errors"],
            "rejectedTotal": c["rejected"],
        }

    def metrics(self):
        """The ``pilosa_ingest_*`` group, by the reference's names."""
        with self._mu:
            c = dict(self._c)
            seeded = dict(self._c["seeded"])
        out = {
            "batches_total": c["batches"],
            "bits_total": c["bits"],
            "values_total": c["values"],
            "slice_groups_total": c["slices"],
            "fanout_posts_total": c["fanout_posts"],
            "pack_passes_total": c["pack_passes"],
            "errors_total": c["errors"],
            "rejected_total": c["rejected"],
        }
        for fmt, n in seeded.items():
            out[f"containers_seeded_total;format:{fmt}"] = n
        return out
