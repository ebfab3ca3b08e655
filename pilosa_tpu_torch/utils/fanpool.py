"""Persistent bounded fan-out thread pool (counterpart of
pilosa_tpu/utils/fanpool.py).

The executor's multi-node map/reduce runs one task per (node, round);
a fresh ``threading.Thread`` per task is pure per-query overhead, so
this pool keeps up to ``max_idle`` parked workers and hands tasks to
them over a per-worker condition variable.

- ``run()`` never blocks and never queues: fan-out tasks may fan out
  again (a TopN phase from a pool thread), and a bounded queue would
  deadlock once nested fan-outs filled it. With no parked worker free
  and the persistent cap reached, the task runs on a one-shot daemon
  thread.
- Callers own error handling: a task catches its own exceptions (the
  executor's fan-out closures do); a stray raise is swallowed so it
  cannot kill a pooled worker.
- ``run()`` returns an Event whose ``wait()`` joins the task; it is set
  in a ``finally``, so a raising task never wedges its joiner.
"""
import threading
import time

_CLOSED = object()


def wait_all(handles, deadline=None, clock=time.monotonic):
    """Join a fan-out round, each wait bounded by what is left until
    ``deadline`` (a ``clock()`` instant, never the wall clock). True
    when every task completed, False when the budget ran out first."""
    ok = True
    for h in handles:
        if deadline is None:
            h.wait()
        elif not h.wait(max(0.0, deadline - clock())):
            ok = False  # keep polling: later handles may be done
    return ok


def run_all(pool, fns, width=None):
    """Run every function of ``fns`` on ``pool``, ``width`` at a time (all
    at once by default), wait for all of them, then raise the first
    failure in their order: the callers' all-or-nothing acknowledgement
    over every owner or slice."""
    errs = [None] * len(fns)

    def run(i, fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errs[i] = exc

    width = width or max(1, len(fns))
    for off in range(0, len(fns), width):
        wait_all([pool.run(lambda i=off + k, fn=fn: run(i, fn))
                  for k, fn in enumerate(fns[off:off + width])])
    for exc in errs:
        if exc is not None:
            raise exc


class _Worker:
    __slots__ = ("_pool", "_cv", "_task")

    def __init__(self, pool):
        self._pool = pool
        self._cv = threading.Condition(threading.Lock())
        self._task = None
        threading.Thread(target=self._loop, daemon=True,
                         name="fanpool-worker").start()

    def _loop(self):
        while True:
            with self._cv:
                while self._task is None:
                    self._cv.wait()
                task, self._task = self._task, None
            if task is _CLOSED:
                return
            fn, done = task
            try:
                fn()
            except BaseException:  # noqa: BLE001 — see module docstring
                pass
            finally:
                done.set()
            # Drop the task before parking: an idle worker must not pin
            # its last fan-out's closure (partial results, slice lists).
            task = fn = done = None  # noqa: F841
            if not self._pool._checkin(self):
                return

    def _submit(self, task):
        with self._cv:
            self._task = task
            self._cv.notify()


def _spill(fn, done):
    try:
        fn()
    except BaseException:  # noqa: BLE001 — as pooled workers
        pass
    finally:
        done.set()


class FanoutPool:
    """See the module docstring; ``stats()`` counts runs and spills."""

    def __init__(self, max_idle=16):
        self.max_idle = max_idle
        self._mu = threading.Lock()
        self._idle = []
        self._persistent = 0
        self._closed = False
        self.runs = 0
        self.spilled = 0

    def run(self, fn):
        """Run ``fn`` on a pooled (or one-shot) thread; returns its
        completion Event."""
        done = threading.Event()
        task = (fn, done)
        mint = False
        with self._mu:
            self.runs += 1
            w = self._idle.pop() if self._idle else None
            if (w is None and not self._closed
                    and self._persistent < self.max_idle):
                self._persistent += 1
                mint = True
            if w is None and not mint:
                self.spilled += 1
        if w is None:
            if not mint:
                threading.Thread(target=_spill, args=task, daemon=True,
                                 name="fanpool-spill").start()
                return done
            w = _Worker(self)
        w._submit(task)
        return done

    def _checkin(self, worker):
        """Back to the idle list; False tells the worker to exit (the
        pool closed while it was busy)."""
        with self._mu:
            if self._closed:
                self._persistent -= 1
                return False
            self._idle.append(worker)
            return True

    def close(self):
        """Release every parked worker; busy ones exit at check-in."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            idle, self._idle = self._idle, []
            self._persistent -= len(idle)
        for w in idle:
            w._submit(_CLOSED)

    def stats(self):
        with self._mu:
            return {"runs": self.runs, "spilled": self.spilled,
                    "persistent": self._persistent,
                    "idle": len(self._idle)}
