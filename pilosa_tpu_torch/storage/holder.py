"""Holder — root registry of all indexes under a data directory
(ref: holder.go:46-70; counterpart of pilosa_tpu/storage/holder.py).

The directory layout is pilosa_tpu's:
``<root>/<index>/<frame>/views/<view>/fragments/<slice>``. The holder
takes ONE exclusive flock on ``<root>/.holder.lock`` for its lifetime
(the protocol of pilosa_tpu holder.py:133-150), so the two packages
never have the same directory open at once: close one package's holder
before the other opens it.

The holder's device is where every fragment mirrors its rows and where
queries run. It is the GPU unless the caller asks for the CPU; without
a GPU, ``Holder(path)`` raises rather than carrying on on the CPU.

Opening reads no fragment file: fragments load on first touch, and a
host-memory governor (``storage/memgov.py``) bounds the host bytes of
resident fragments at ``host_bytes`` (or ``PILOSA_TPU_HOST_BYTES``),
unloading the least recently used; None is unbounded. A fragment read
lazily holds its file's descriptor while its reader lives, so opening
raises the soft descriptor limit toward the hard one, as the reference
does, and the reader cap follows it (``fragment.reader_cap``).
"""
import os
import resource
import shutil
import threading
import uuid

import torch

from pilosa_tpu_torch import errors as perr
from pilosa_tpu_torch.storage.fragment import HOLDER_LOCK_NAME, try_flock
from pilosa_tpu_torch.storage.index import Index
from pilosa_tpu_torch.storage.memgov import HostMemGovernor


def resolve_device(device):
    """torch.device for ``device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pilosa_tpu_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev


def host_bytes_from_env():
    """The host-memory budget ``PILOSA_TPU_HOST_BYTES`` names, or None
    when it is unset or not a positive byte count (read as pilosa_tpu
    holder.py:36-45 reads it)."""
    env = os.environ.get("PILOSA_TPU_HOST_BYTES")
    if not env:
        return None
    try:
        value = int(env)
    except ValueError:
        return None
    return value if value > 0 else None


class Holder:
    def __init__(self, path, device="cuda", host_bytes=None):
        self.path = path
        self.device = resolve_device(device)
        if host_bytes is None:
            host_bytes = host_bytes_from_env()
        self.governor = HostMemGovernor(host_bytes)
        self.mu = threading.RLock()
        self.indexes = {}
        self.local_id = None
        self._dir_lock = None
        # Called with an index's name after its deletion: the executor
        # drops the plan and memo entries a deleted index never reads.
        self.on_index_drop = None

    def open(self):
        """Lock the directory and open every index (ref: holder.go:87-150)."""
        with self.mu:
            os.makedirs(self.path, exist_ok=True)
            self._dir_lock = try_flock(
                os.path.join(self.path, HOLDER_LOCK_NAME),
                perr.ErrHolderLocked)
            try:
                self._set_file_limit()
                for entry in sorted(os.listdir(self.path)):
                    full = os.path.join(self.path, entry)
                    if os.path.isdir(full) and not entry.startswith("."):
                        self.indexes[entry] = self._new_index(entry).open()
                self._load_local_id()
            except BaseException:
                self.close()
                raise
        return self

    def close(self):
        with self.mu:
            try:
                for idx in self.indexes.values():
                    idx.close()
                self.indexes = {}
            finally:
                if self._dir_lock is not None:
                    self._dir_lock.close()
                    self._dir_lock = None

    @staticmethod
    def _set_file_limit(target=262144):
        """Raise the soft RLIMIT_NOFILE toward ``target`` within the hard
        limit (ref: setFileLimit holder.go:385-431; pilosa_tpu
        holder.py:190-216): the readers of lazily read fragments hold a
        descriptor each, and a default soft limit of 1,024 runs out long
        before the reader cap. Where the kernel refuses the hard limit
        (darwin), the reference's fallback of 10,240."""
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft == resource.RLIM_INFINITY:
            return
        want = target if hard == resource.RLIM_INFINITY else min(target,
                                                                 hard)
        if soft >= want:
            return
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
        except (ValueError, OSError):
            if soft < 10240:
                resource.setrlimit(resource.RLIMIT_NOFILE, (10240, hard))

    def _load_local_id(self):
        """The node's UUID, persisted at ``<data>/.id`` (ref:
        holder.go:435-453; the file pilosa_tpu reads and writes)."""
        id_path = os.path.join(self.path, ".id")
        if os.path.exists(id_path):
            with open(id_path) as f:
                self.local_id = f.read().strip()
        else:
            self.local_id = str(uuid.uuid4())
            with open(id_path, "w") as f:
                f.write(self.local_id)

    def _new_index(self, name):
        return Index(os.path.join(self.path, name), name,
                     device=self.device, holder_locked=True,
                     governor=self.governor)

    def index(self, name):
        with self.mu:
            return self.indexes.get(name)

    def create_index(self, name, column_label="", time_quantum=""):
        with self.mu:
            if not name:
                raise perr.ErrIndexRequired()
            if name in self.indexes:
                raise perr.ErrIndexExists()
            idx = self._new_index(name).open()
            if column_label:
                idx.column_label = perr.validate_label(column_label)
            if time_quantum:
                idx.set_time_quantum(time_quantum)
            idx.save_meta()
            self.indexes[name] = idx
            return idx

    def delete_index(self, name):
        """Close the index and remove its directory (ref: holder.go
        DeleteIndex). Its fragments' closes move its epoch, and a new
        index of the same name starts from a fresh epoch value, so no
        cached stack of the deleted one is ever reused."""
        with self.mu:
            idx = self.indexes.pop(name, None)
            if idx is None:
                raise perr.ErrIndexNotFound()
        idx.close()
        idx.epoch.bump()
        shutil.rmtree(idx.path, ignore_errors=True)
        if self.on_index_drop is not None:
            self.on_index_drop(name)

    def schema(self):
        """[{name, frames: [{name, views: [{name}]}]}], every list
        sorted by name (ref: holder.go:173)."""
        with self.mu:
            indexes = [self.indexes[k] for k in sorted(self.indexes)]
        out = []
        for idx in indexes:
            with idx.mu:
                frames = [idx.frames[k] for k in sorted(idx.frames)]
            out.append({"name": idx.name, "frames": [
                {"name": fr.name,
                 "views": [{"name": v} for v in sorted(list(fr.views))]}
                for fr in frames]})
        return out

    def recalculate_caches(self):
        """Rebuild every fragment's TopN cache from storage and write
        its sidecar (ref: handleRecalculateCaches handler.go:2016)."""
        with self.mu:
            for idx in list(self.indexes.values()):
                for frame in list(idx.frames.values()):
                    for view in list(frame.views.values()):
                        for frag in list(view.fragments.values()):
                            frag.recalculate_cache()
                            frag.flush_cache()

    _MEM_KEYS = ("hostBytes", "deviceBytes", "lazyBytes", "diskBytes",
                 "cacheEntries")

    def memory_stats(self):
        """Per-index and total memory occupancy — host matrix bytes of
        resident fragments, device bytes of their tensors, lazy-read
        memo bytes, file bytes on disk, TopN cache entries, fragment and
        resident-fragment counts, and the compressed container tier's
        rollup by format — and the governor's gauges (ref: pilosa_tpu
        holder.py:645-720, without its 2 s memo)."""
        with self.mu:
            indexes = [(name, self.indexes[name])
                       for name in sorted(self.indexes)]
        per_index = {}
        totals = dict.fromkeys(self._MEM_KEYS, 0)
        totals["fragments"] = totals["residentFragments"] = 0
        totals["containers"] = self._empty_container_agg()
        for name, idx in indexes:
            agg = dict.fromkeys(self._MEM_KEYS, 0)
            agg["fragments"] = agg["residentFragments"] = 0
            cagg = self._empty_container_agg()
            for frame in list(idx.frames.values()):
                for view in list(frame.views.values()):
                    for frag in list(view.fragments.values()):
                        m = frag.memory_stats()
                        agg["fragments"] += 1
                        agg["residentFragments"] += int(m["resident"])
                        for k in self._MEM_KEYS:
                            agg[k] += m[k]
                        self._add_container_agg(cagg, m["containers"])
            agg["containers"] = cagg
            per_index[name] = agg
            for k, v in agg.items():
                if k == "containers":
                    self._add_container_agg(totals["containers"], v)
                else:
                    totals[k] += v
        return {"indexes": per_index, "totals": totals,
                "governor": self.governor.snapshot()}

    @staticmethod
    def _empty_container_agg():
        """A zeroed container rollup: dense/array/run blocks and payload
        bytes, the dense-tier bytes of the same blocks, conversions."""
        return {"formats": {f: {"blocks": 0, "bytes": 0}
                            for f in ("dense", "array", "run")},
                "denseEquivBytes": 0, "conversions": 0}

    @staticmethod
    def _add_container_agg(into, c):
        for fmt, fv in c["formats"].items():
            into["formats"][fmt]["blocks"] += fv["blocks"]
            into["formats"][fmt]["bytes"] += fv["bytes"]
        into["denseEquivBytes"] += c["denseEquivBytes"]
        into["conversions"] += c["conversions"]

    def fragment(self, index, frame, view, slice_num):
        """Accessor chain (ref: holder.go:196-338)."""
        return self.fragments(index, frame, view, [slice_num])[0]

    def fragments(self, index, frame, view, slices):
        """One lookup per slice after resolving index→frame→view once,
        under one hold of the view's lock (a lock a slice convoys when
        many request threads walk at once)."""
        idx = self.index(index)
        fr = idx.frame(frame) if idx is not None else None
        v = fr.view(view) if fr is not None else None
        if v is None:
            return [None] * len(slices)
        with v.mu:
            get = v.fragments.get
            return [get(s) for s in slices]

    def max_slices(self):
        """{index: max_slice}."""
        with self.mu:
            return {name: idx.max_slice()
                    for name, idx in self.indexes.items()}

    def max_inverse_slices(self):
        """{index: max_inverse_slice}."""
        with self.mu:
            return {name: idx.max_inverse_slice()
                    for name, idx in self.indexes.items()}
