#!/usr/bin/env python3
"""Builds of count_op_rows/count_rows, count_and_rows and
container_and_counts side by side on one card: another checkout's CUDA
sources (``--parent``, the commit before a kernel change) against this
checkout's, and this checkout's with their thresholds rewritten so that
one regime serves every shape (``full``, ``split``, ``narrow``; for
containers.cu ``warp`` and ``block``, every member a warp or a block),
so that two regimes meet at the same shape.

    python3 pilosa_tpu_torch/tools/kernel_ab.py --parent DIR [--out FILE]
        [--build-dir DIR] [--only popcount,count_and_rows,containers]

DIR is the root of the other checkout (its ``pilosa_tpu_torch/csrc``
is built); the builds go to ``pilosa_tpu_torch/_build/ab/``, one nvcc
process per source, all at once. Each build is called through the same
thin ctypes caller and its counts held against the plain versions
(exactly); every build that took a regime reports it, and a rewritten
build must take the regime it was rewritten to. Per (shape, build):

- ``dev``: ``chip_smoke.cold_ms``, a CUDA graph's launches back to back
  over inputs cycled past the L2 cache (up to its copy limit);
- ``lone``: ``chip_smoke.one_ms``, one launch alone on cold inputs;
- ``call``: ``chip_smoke.timed_ms``, warm calls from the host;
- ``wait`` (serial shapes): ``chip_smoke.sync_ms``, a call and a
  synchronize.

Prints one line per shape and writes every number to FILE as JSON.
"""
import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = {"popcount": "popcount.cu", "count_and_rows": "count_and_rows.cu",
           "containers": "containers.cu"}
# The constants that force one regime on every shape (ops/kernels.py
# REGIMES): a narrow limit below every width, a split limit above or
# below every shape. count_and_rows's narrow body holds at most 512 words
# of filter a group, so its forced narrow build serves only those.
FORCE = {
    "popcount": {
        "full": {"NARROW_MAX_WORDS": "-1", "SPLIT_ROWS": "0"},
        "split": {"NARROW_MAX_WORDS": "-1", "SPLIT_MIN_WORDS": "-1",
                  "SPLIT_ROWS": "1LL << 40"},
        "narrow": {"NARROW_MAX_WORDS": "1LL << 40", "NARROW_MIN_ROWS": "0"}},
    "count_and_rows": {
        "full": {"NARROW_MAX_WORDS": "-1", "SPLIT_ITEMS": "0"},
        "split": {"NARROW_MAX_WORDS": "-1", "SPLIT_MIN_WORDS": "-1",
                  "SPLIT_ITEMS": "1LL << 40"},
        "narrow": {"NARROW_MIN_ROWS": "0"}},
    # container_and_counts: every member a warp (a member over a warp's
    # buffers read in place) or every member a block.
    "containers": {
        "warp": {"BLOCK_MIN_INTS": "1LL << 40", "BLOCK_ALL_MAX_N": "0"},
        "block": {"BLOCK_MIN_INTS": "-1"}},
}
REGIMES = ("full", "narrow", "split")
REGIME_SYMBOL = {"popcount": "pilosa_count_op_rows_regime",
                 "count_and_rows": "pilosa_count_and_rows_regime"}
OP_NONE, OP_AND = 0, 1
SLICES = 9537
WORDS32 = 32768


def rewrite(text, consts):
    """``text`` with each ``constexpr long long NAME = ...;`` of
    ``consts`` set to its value; each must occur exactly once."""
    for name, value in consts.items():
        text, n = re.subn(rf"(constexpr long long {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"kernel_ab: {name} found {n} times")
    return text


def build_all(parent, build_dir, sources):
    """{(source, build): library path}, compiled in parallel."""
    sys.path.insert(0, ROOT)
    from pilosa_tpu_torch.ops import loader

    os.makedirs(build_dir, exist_ok=True)
    jobs = {}
    for src in sources:
        fname = SOURCES[src]
        with open(os.path.join(ROOT, "pilosa_tpu_torch", "csrc", fname)) as f:
            this = f.read()
        with open(os.path.join(parent, "pilosa_tpu_torch", "csrc",
                               fname)) as f:
            texts = {"parent": f.read(), "this": this}
        for regime, consts in FORCE[src].items():
            texts[regime] = rewrite(this, consts)
        for name, text in texts.items():
            cu = os.path.join(build_dir, f"{src}-{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = os.path.join(build_dir, f"lib{src}-{name}.so")
            jobs[(src, name)] = (so, subprocess.Popen(
                [loader.nvcc_path(), *loader.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    for key, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: build {key} failed:\n"
                             f"{out.decode(errors='replace')}")
    print(f"kernel_ab: {len(jobs)} builds in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    return {k: so for k, (so, _) in jobs.items()}


class Build:
    """One built library, called as the package's wrappers call theirs
    (an output tensor, the current stream, the error code checked)."""

    def __init__(self, src, name, path):
        self.src, self.name = src, name
        self.lib = ctypes.CDLL(path)
        self.regime = ctypes.c_int(-1)
        # A library that exports its regime takes a regime pointer last.
        self.reports = hasattr(self.lib, REGIME_SYMBOL[src])
        tail = [ctypes.POINTER(ctypes.c_int)] if self.reports else []
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        if src == "popcount":
            self.op_fn = self.lib.pilosa_count_op_rows
            self.op_fn.argtypes = [vp, vp, ll, ll, ctypes.c_int, vp,
                                   vp] + tail
            self.op_fn.restype = ctypes.c_int
        else:
            self.table_fn = self.lib.pilosa_count_and_rows
            self.table_fn.argtypes = [vp, ctypes.c_int, vp, ll, ll, vp, ll,
                                      vp] + tail
            self.table_fn.restype = ctypes.c_int
            self.strided_fn = self.lib.pilosa_count_and_rows_strided
            self.strided_fn.argtypes = [vp, ll, ll, vp, ll, ll, vp, ll,
                                        vp] + tail
            self.strided_fn.restype = ctypes.c_int

    def _call(self, fn, *args):
        import torch

        tail = (ctypes.byref(self.regime),) if self.reports else ()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream, *tail)
        if rc != 0:
            raise RuntimeError(f"{self.src}-{self.name}: CUDA error {rc}")

    def op_rows(self, a, b, op):
        import torch

        out = torch.empty(a.shape[:-1], dtype=torch.int32, device=a.device)
        self._call(self.op_fn, a.data_ptr(), b.data_ptr(),
                   math.prod(a.shape[:-1]), a.shape[-1], op, out.data_ptr())
        return out

    def frag(self, m, f):
        import torch

        out = torch.empty(m.shape[0], dtype=torch.int32, device=m.device)
        self._call(self.strided_fn, m.data_ptr(), m.shape[1], m.shape[0],
                   f.data_ptr(), 1, m.shape[1], out.data_ptr(), 1)
        return out

    def stacks(self, rows, f):
        import numpy as np
        import torch

        slices, width = f.shape
        out = torch.empty((len(rows), slices), dtype=torch.int32,
                          device=f.device)
        table = np.asarray([r.data_ptr() for r in rows], dtype=np.uint64)
        self._call(self.table_fn, table.ctypes.data, len(rows),
                   f.data_ptr(), slices, width, out.data_ptr(), slices)
        return out

    def taken(self):
        return REGIMES[self.regime.value] if self.reports else "full"


CONT_CELLS = {"array_array": 0, "array_run": 1, "array_dense": 2,
              "run_dense": 3}


class ContBuild:
    """One build of csrc/containers.cu, called over one packed side each
    (the identity form of the member table): the parent's interface (a
    grid of (N, G) blocks, out zeroed, the wrapper's blocks-per-member
    rule) or this one's (the kernel spreads the members itself)."""

    def __init__(self, src, name, path):
        self.src, self.name = src, name
        self.lib = ctypes.CDLL(path)
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        self.new = hasattr(self.lib, "pilosa_containers_thresholds")
        self.fn = self.lib.pilosa_container_and_counts
        self.fn.restype = ci
        if self.new:
            self.fn.argtypes = [ci, ll, vp, ci, vp, ci, vp, ll, vp, vp]
        else:
            self.fn.argtypes = [ci, ll] + [vp] * 8 + [ll, ci, vp, vp]

    def caller(self, cell, n, width):
        """fn(a0, a1, a_offs, b0, b1, b_offs) -> int32[N]: b0 is a dense
        cell's device table of row pointers; unused slots are ignored."""
        import numpy as np
        import torch

        code = CONT_CELLS[cell]
        dense = cell.endswith("dense")

        def run(a0, a1, ao, b0, b1, bo):
            stream = torch.cuda.current_stream().cuda_stream
            if self.new:
                out = torch.empty(n, dtype=torch.int32, device="cuda")
                pa = np.asarray([a0.data_ptr(), a1.data_ptr(),
                                 ao.data_ptr()], dtype=np.uint64)
                pb = np.asarray([0, b0.data_ptr(), 0] if dense else
                                [b0.data_ptr(), b1.data_ptr(), bo.data_ptr()],
                                dtype=np.uint64)
                rc = self.fn(code, n, pa.ctypes.data, 1, pb.ctypes.data, 1,
                             None, width, out.data_ptr(), stream)
            else:
                out = torch.zeros(n, dtype=torch.int32, device="cuda")
                per = max(1, min(64, -(-2 * 132 // n)))
                rc = self.fn(code, n, a0.data_ptr(), a1.data_ptr(),
                             ao.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                             bo.data_ptr(), 0,
                             b0.data_ptr() if dense else None, width, per,
                             out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"containers-{self.name}: CUDA error {rc}")
            return out
        return run


def container_ab(builds, smoke, card):
    """container_and_counts: the parent's build against this one at the
    lane shapes (GROUP_PAIRS row pairs over MAIN_SLICES slices: members
    of phase 10's 500 and 300 positions, its 2,000-bit run, dense rows)
    and at the serial shapes (one member); then this build against its
    forced ``warp`` and ``block`` builds across member sizes around the
    threshold and member counts around BLOCK_ALL_MAX_N. Returns the
    rows."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import containers as C
    from pilosa_tpu_torch.ops import kernels

    rng = np.random.default_rng(77)
    limit, w32 = smoke.SLICE_COLS, smoke.WORDS32
    rows_out = []
    dummy = torch.zeros(4, dtype=torch.int32, device="cuda")
    pool = [torch.from_numpy(rng.integers(-2**31, 2**31, w32, dtype=np.int64)
                             .astype(np.int32)).cuda() for _ in range(2048)]

    def arrays(n, k, distinct=256):
        parts = [np.sort(rng.choice(limit, k, replace=False)).astype(np.int32)
                 for _ in range(min(n, distinct))]
        conts = [C.Container("array", w32, k, positions=parts[i % len(parts)],
                             device="cuda") for i in range(n)]
        vals, offs = C.stack_positions(conts)
        return conts, (vals, dummy, offs)

    def runs(n):
        starts = rng.integers(0, limit - 3000, n)
        conts = [C.Container("run", w32, 2000, runs=np.array(
            [[s0, s0 + 2000]], np.int32), device="cuda") for s0 in starts]
        return conts, C.stack_runs(conts)

    def dense(n):
        rows = [pool[i % len(pool)] for i in range(n)]
        ptrs = np.asarray([r.data_ptr() for r in rows], dtype=np.uint64)
        return rows, (torch.from_numpy(ptrs.view(np.int64)).cuda(), dummy,
                      dummy)

    def make(cell, n, ka=500, kb=300):
        """(args, plain result, bound ms)."""
        fa, fb = cell.split("_")
        ca, sa = arrays(n, ka) if fa == "array" else runs(n)
        if fb == "array":
            cb, sb = arrays(n, kb)
            plain_b = (sb[0], sb[2])
        elif fb == "run":
            cb, sb = runs(n)
            plain_b = sb
        else:
            rows, sb = dense(n)
            cb = [C.dense_container(r, w32, 0) for r in rows]
            plain_b = rows
        plain_a = (sa[0], sa[2]) if fa == "array" else sa
        want = kernels.container_and_counts_plain(cell, plain_a, plain_b)
        shared = np.arange(n) % len(pool) if fb == "dense" else None
        bound = smoke.cont_bound_ms(cell, ca, cb, shared)[0]
        return (*sa, *sb), want, bound

    def measure(group, cell, n, names, ka=500, kb=300, serial=False):
        args_, want, bound = make(cell, n, ka, kb)
        shape = f"{cell} N = {n} ({ka} x {kb})" if cell == "array_array" \
            else f"{cell} N = {n}"
        row = {"group": group, "kernel": "container_and_counts",
               "shape": shape, "bound_ms": bound, "builds": {}}
        for name in names:
            b = builds[("containers", name)]
            fn = b.caller(cell, n, w32)
            got = fn(*args_)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"kernel_ab: containers-{name} != plain at "
                                 f"{shape}")
            t = {"dev": smoke.cold_ms(fn, *args_),
                 "lone": smoke.one_ms(fn, *args_, reps=30),
                 "call": smoke.timed_ms(lambda: fn(*args_), reps=50)}
            if serial:
                t["wait"] = smoke.sync_ms(lambda: fn(*args_))
            row["builds"][name] = t
        rows_out.append(row)
        print(f"{group} | {shape} | bound {bound:.5f} | " + " | ".join(
            f"{nm} dev {t['dev']:.4f} ({bound / t['dev']:.1%}) lone "
            f"{t['lone']:.4f} call {t['call']:.4f}"
            + (f" wait {t['wait']:.4f}" if "wait" in t else "")
            for nm, t in row["builds"].items()) + f" {card}")
        del args_, want
        torch.cuda.empty_cache()

    lane_n = smoke.GROUP_PAIRS * smoke.MAIN_SLICES
    for cell in CONT_CELLS:
        measure("lane", cell, lane_n, ("parent", "this", "warp", "block")
                if cell == "array_array" else ("parent", "this"))
    for cell in CONT_CELLS:
        measure("serial", cell, 1, ("parent", "this", "warp", "block"),
                serial=True)
    # Member sizes around BLOCK_MIN_INTS at a lane's ~61M staged ints.
    for k in (128, 256, 400, 512, 640, 768, 1024, 1100, 2048, 4096):
        measure("warp|block", "array_array", max(1, 61_000_000 // (2 * k)),
                ("this", "warp", "block"), ka=k, kb=k)
    # Member counts around BLOCK_ALL_MAX_N.
    for n in (2, 7, 16, 32, 64, 65, 128, 256, 512, 1024, 4096):
        measure("warp|block", "array_array", n, ("this", "warp", "block"),
                serial=n <= 16)
    return rows_out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--build-dir", default=os.path.join(
        ROOT, "pilosa_tpu_torch", "_build", "ab"))
    ap.add_argument("--out", help="JSON file (default: kernel_ab.json in "
                    "the build directory)")
    ap.add_argument("--only", default=",".join(SOURCES),
                    help="comma-separated sources to build and time (default:"
                         " all)")
    args = ap.parse_args()
    sources = [x for x in args.only.split(",") if x]
    if not sources or set(sources) - set(SOURCES):
        ap.error(f"--only takes sources of {sorted(SOURCES)}")
    args.out = args.out or os.path.join(args.build_dir, "kernel_ab.json")
    sys.stdout.reconfigure(line_buffering=True)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from pilosa_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    builds = {k: (ContBuild if k[0] == "containers" else Build)(*k, path)
              for k, path in build_all(os.path.abspath(args.parent),
                                       args.build_dir, sources).items()}
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device="cuda", generator=gen)

    kinds = {  # kind: (source, caller of a build, plain version, bound)
        "count_op_rows[and]": (
            "popcount", lambda b: lambda x, y: b.op_rows(x, y, OP_AND),
            lambda x, y: kernels.count_op_rows_plain(x, y, "and"),
            lambda x, y: smoke.bound_ms(
                math.prod(x.shape[:-1]), x.shape[-1], 2)[0]),
        "count_rows": (
            "popcount", lambda b: lambda x: b.op_rows(x, x, OP_NONE),
            kernels.count_rows_plain,
            lambda x: smoke.bound_ms(math.prod(x.shape[:-1]), x.shape[-1],
                                     1)[0]),
        "count_and_rows fragment": (
            "count_and_rows", lambda b: b.frag, kernels.count_and_rows_plain,
            lambda m, f: smoke.and_rows_bound_ms(m.shape[0], 1,
                                                 m.shape[1])[0]),
        "count_and_rows 8 stacks": (
            "count_and_rows", lambda b: b.stacks,
            kernels.count_and_rows_stacks_plain,
            lambda rows, f: smoke.and_rows_bound_ms(len(rows), *f.shape)[0]),
    }
    results = []
    from pilosa_tpu_torch.ops import loader

    empty = loader.library("popcount").pilosa_empty_launch
    empty.argtypes = [ctypes.c_void_p]

    def empty_call():
        empty(torch.cuda.current_stream().cuda_stream)

    floor = {"dev": smoke.graph_ms(empty_call, reps=200),
             "lone": smoke.one_ms(empty_call),
             "call": smoke.timed_ms(empty_call, reps=200),
             "wait": smoke.sync_ms(empty_call)}
    print(f"floor, an empty kernel: {json.dumps(floor)} {card}")

    def measure(group, kind, names, make, serial=False):
        src, caller, plain, bound = kinds[kind]
        if src not in sources:
            return
        args_ = make()
        want = plain(*args_)
        shape = (f"{len(args_[0])} x {list(args_[1].shape)}"
                 if isinstance(args_[0], list) else
                 " & ".join(str(list(t.shape)) for t in args_))
        row = {"group": group, "kernel": kind, "shape": shape,
               "bound_ms": bound(*args_), "builds": {}}
        for name in names:
            b = builds[(src, name)]
            fn = caller(b)
            got = fn(*args_)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"kernel_ab: {src}-{name} != plain at "
                                 f"{kind} {shape}")
            taken = b.taken()
            if name in FORCE[src] and taken != name:
                raise SystemExit(f"kernel_ab: {src}-{name} took {taken} at "
                                 f"{kind} {shape}")
            t = {"regime": taken,
                 "dev": smoke.cold_ms(fn, *args_),
                 "lone": smoke.one_ms(fn, *args_, reps=30),
                 "call": smoke.timed_ms(lambda: fn(*args_), reps=50)}
            if serial:
                t["wait"] = smoke.sync_ms(lambda: fn(*args_))
            row["builds"][name] = t
        results.append(row)
        print(f"{group} | {kind} {shape} | bound {row['bound_ms']:.5f} | "
              + " | ".join(
                  f"{n} ({t['regime']}) dev {t['dev']:.4f} lone "
                  f"{t['lone']:.4f} call {t['call']:.4f}"
                  + (f" wait {t['wait']:.4f}" if "wait" in t else "")
                  for n, t in row["builds"].items()) + f" {card}")
        del args_, want

    pair = ("parent", "this")
    # Before and after: the window buckets, the fragment form, the serial
    # shapes.
    for w in (128, 512, 2048, 8192, WORDS32):
        measure("bucket", "count_op_rows[and]", pair,
                lambda: (rand(SLICES, w), rand(SLICES, w)))
        measure("bucket", "count_rows", pair, lambda: (rand(SLICES, w),))
        measure("bucket", "count_and_rows 8 stacks", pair,
                lambda: ([rand(SLICES, w) for _ in range(8)],
                         rand(SLICES, w)))
        torch.cuda.empty_cache()
    measure("fragment", "count_and_rows fragment", pair + ("full",),
            lambda: (rand(524_288, 128), rand(128)))
    for w in (WORDS32, 128):
        measure("serial", "count_op_rows[and]", pair,
                lambda: (rand(w), rand(w)), serial=True)
        measure("serial", "count_rows", pair, lambda: (rand(w),),
                serial=True)
    for r in (8, 11):
        measure("serial", "count_and_rows fragment", pair,
                lambda: (rand(r, WORDS32), rand(WORDS32)), serial=True)
    # Two regimes at one shape, and the regime this build takes there:
    # split against the full body (the parent's body, unchanged, beside
    # it) ...
    three = ("this", "parent", "full", "split")
    for r, w in ((1, 1024), (1, 2048), (1, 4100), (1, 8192), (1, 8196),
                 (1, 16384), (1, WORDS32), (8, 4100), (8, 8192),
                 (8, 8196), (8, 16384), (8, WORDS32), (32, WORDS32),
                 (63, WORDS32), (64, WORDS32), (96, WORDS32),
                 (127, WORDS32), (128, WORDS32)):
        measure("split|full", "count_op_rows[and]", three,
                lambda: (rand(r, w), rand(r, w)), serial=r == 1)
        measure("split|full", "count_rows", three, lambda: (rand(r, w),),
                serial=r == 1)
    for r, w in ((8, 1024), (8, 2048), (8, 2052), (8, 4100), (8, 8192),
                 (8, 16384), (8, WORDS32), (11, 2048), (11, 8192),
                 (11, WORDS32), (64, WORDS32), (256, WORDS32),
                 (504, WORDS32), (512, WORDS32), (768, WORDS32),
                 (1016, WORDS32), (1024, WORDS32)):
        measure("split|full", "count_and_rows fragment", three,
                lambda: (rand(r, w), rand(w)), serial=r <= 11)
    # ... and narrow against the full body.
    for r, w in ((SLICES, 256), (SLICES, 512), (SLICES, 516),
                 (SLICES, 1024), (SLICES, 2048), (64, 512), (256, 128),
                 (256, 512), (1023, 128), (1024, 128), (1023, 512),
                 (1024, 512), (4096, 128), (4096, 512), (1, 516),
                 (1, 1024)):
        measure("narrow|full", "count_op_rows[and]",
                ("this", "narrow", "full"),
                lambda: (rand(r, w), rand(r, w)), serial=r == 1)
        measure("narrow|full", "count_rows", ("this", "narrow", "full"),
                lambda: (rand(r, w),), serial=r == 1)
    for r, w in ((524_288, 128), (65_536, 512), (SLICES, 256),
                 (SLICES, 512), (4096, 128), (1024, 128), (1023, 128),
                 (1024, 512), (256, 128), (11, 512), (11, 128)):
        measure("narrow|full", "count_and_rows fragment",
                ("this", "narrow", "full"), lambda: (rand(r, w), rand(w)))
    for w in (128, 512):
        measure("narrow|full", "count_and_rows 8 stacks",
                ("this", "narrow", "full"),
                lambda: ([rand(SLICES, w) for _ in range(8)],
                         rand(SLICES, w)))
    if "containers" in sources:
        results += container_ab(builds, smoke, card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "floor": floor, "shapes": results}, f,
                  indent=1)
    print(f"kernel_ab: {len(results)} shapes, every build exact; "
          f"{args.out} {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
