#!/usr/bin/env python3
"""Smoke run of pilosa_tpu_torch's main path on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py [--slices N]``.

Phases, each of which fails the run (exit code != 0, no result line):

1. device — the card's name and ``nvidia-smi`` name/power limit;
2. build — compile every CUDA source under pilosa_tpu_torch/csrc;
3. kernels — each kernel against its plain PyTorch version on the same
   device tensors, exactly, at the main-path shape [slices, 32768] and
   at ragged/edge shapes; time, bytes, bound and plain-version time at
   the main-path shape;
4. main path — a data directory of N slices (default 9,537 = 10.0B
   columns; one index, one frame, three dense rows of bit density 0.5,
   0.5 and 0.25 from ``--seed``) written through ``Fragment.read_from``,
   reopened by a GPU ``Holder``, and queried through
   ``Executor.execute``: Count over Bitmap/Intersect/Union/Difference/
   Xor trees on the batched and the serial path, then SetBit/ClearBit
   and recounts. Every answer must equal a numpy oracle on the same
   words; both kernels must have launched during this phase.

The second-to-last line is a JSON object describing every kernel; the
last is ``{"ok": true, "device": {...}}``. The script exits non-zero
without a GPU, and where the pilosa_tpu_torch package is not beside it.
"""
import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tarfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_SLICES = 9537          # 10.0B columns at 2^20 columns per slice
WORDS32 = 32768             # int32 words per slice row
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
ALU_OPS_PER_S = 67e12       # H100 SXM 32-bit (fp32) non-tensor rate
OPS = ("and", "or", "xor", "andnot")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def timed_ms(fn, reps, warm=2):
    """Mean ms per call by CUDA events over ``reps`` warm calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(rows, width, operands):
    """Least time for a count over [rows, width] words: each input word
    read once and one int32 per row written, against one logic op (none
    for a single operand), one popcount and one add per word at the
    card's 32-bit ALU rate."""
    nbytes = operands * rows * width * 4 + rows * 4
    ops = (operands + 1) * rows * width
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


# ------------------------------------------------------------ phase 3

def kernel_checks(slices, card):
    """Each kernel equal to its plain version; timings at the main
    shape. Returns {kernel name: stats}."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device="cuda", generator=gen)

    max_err = {"count_op_rows": 0, "count_rows": 0}

    def compare(a, b):
        for op in OPS:
            got = kernels.count_op_rows(a, b, op)
            want = kernels.count_op_rows_plain(a, b, op)
            err = int((got.long() - want.long()).abs().max()) if got.numel() \
                else 0
            check(torch.equal(got, want),
                  f"count_op_rows[{op}] != plain at {tuple(a.shape)}")
            max_err["count_op_rows"] = max(max_err["count_op_rows"], err)
        got, want = kernels.count_rows(a), kernels.count_rows_plain(a)
        check(torch.equal(got, want),
              f"count_rows != plain at {tuple(a.shape)}")
        if got.numel():
            max_err["count_rows"] = max(
                max_err["count_rows"],
                int((got.long() - want.long()).abs().max()))

    cases = 0
    for s in (1, 7):
        for w in (1, 3, 192, 32767):
            compare(rand(s, w), rand(s, w))
            cases += 1
    for fill in (0, -1, -2**31):  # all-zero, all-one, bit-31 rows
        m = torch.full((7, WORDS32), fill, dtype=torch.int32, device="cuda")
        compare(m, rand(7, WORDS32))
        cases += 1
    compare(rand(WORDS32), rand(WORDS32))                # 1-D row
    base = rand(7 * 100 + 3)                             # misaligned
    compare(base[1:701].view(7, 100), base[3:703].view(7, 100))
    cases += 2

    a, b = rand(slices, WORDS32), rand(slices, WORDS32)
    compare(a, b)
    cases += 1
    torch.cuda.synchronize()
    print(f"kernels: {cases} shapes exact against the plain versions "
          f"(incl. [{slices}, {WORDS32}]); max_abs_err "
          f"{max_err} {card}")

    stats = {}
    for op in OPS:
        ms = timed_ms(lambda: kernels.count_op_rows(a, b, op), reps=20)
        bms, _, nbytes = bound_ms(slices, WORDS32, 2)
        print(f"count_op_rows[{op}] [{slices}, {WORDS32}]: {ms:.4f} ms, "
              f"reads {nbytes / 1e9:.3f} GB, bound {bms:.4f} ms, "
              f"{bms / ms:.1%} of bound {card}")
        if op == "and":
            stats["count_op_rows"] = {"ms": ms}
    stats["count_op_rows"]["plain_ms"] = timed_ms(
        lambda: kernels.count_op_rows_plain(a, b, "and"), reps=3, warm=1)
    stats["count_rows"] = {
        "ms": timed_ms(lambda: kernels.count_rows(a), reps=20),
        "plain_ms": timed_ms(lambda: kernels.count_rows_plain(a), reps=3,
                             warm=1)}
    for name, operands in (("count_op_rows", 2), ("count_rows", 1)):
        st = stats[name]
        st["bound_ms"], st["bound_by"], st["bytes"] = bound_ms(
            slices, WORDS32, operands)
        st["max_abs_err"] = max_err[name]
        print(f"{name} [{slices}, {WORDS32}]: kernel {st['ms']:.4f} ms, "
              f"plain version {st['plain_ms']:.4f} ms, bytes "
              f"{st['bytes']}, bound {st['bound_ms']:.4f} ms "
              f"({st['bound_by']}), {st['bound_ms'] / st['ms']:.1%} of "
              f"bound; library call: no single PyTorch call (torch has "
              f"no popcount op) {card}")
    print("kernels: " + json.dumps(
        [{"name": n, "launches": c} for n, c in kernels.launches.items()]))
    del a, b, base
    torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------ phase 4

ROW = 'Bitmap(frame="f", rowID={})'
R0, R1, R2 = ROW.format(0), ROW.format(1), ROW.format(2)
QUERIES = [  # (PQL, numpy oracle over (r0, r1, r2) words)
    (f"Count({R0})", lambda w: w[0]),
    (f"Count({R2})", lambda w: w[2]),
    (f"Count(Intersect({R0}, {R1}))", lambda w: w[0] & w[1]),
    (f"Count(Union({R0}, {R1}))", lambda w: w[0] | w[1]),
    (f"Count(Difference({R0}, {R1}))", lambda w: w[0] & ~w[1]),
    (f"Count(Xor({R0}, {R1}))", lambda w: w[0] ^ w[1]),
    (f"Count(Intersect({R0}, {R1}, {R2}))", lambda w: w[0] & w[1] & w[2]),
    (f"Count(Difference(Union({R0}, {R2}), Intersect({R1}, {R2})))",
     lambda w: (w[0] | w[2]) & ~(w[1] & w[2])),
]


def slice_words(seed, s):
    """uint64[3, 16384]: rows 0 and 1 at bit density 0.5, row 2 at 0.25."""
    rng = np.random.default_rng([seed, s])
    w = rng.integers(0, 1 << 64, size=(4, 16384), dtype=np.uint64)
    return np.stack([w[0], w[1], w[2] & w[3]])


def slice_counts(words):
    return [int(np.bitwise_count(fn(words)).sum()) for _, fn in QUERIES]


def backup_tar(words):
    """A fragment backup archive (data + cache members) of three rows,
    made by the port's codec."""
    from pilosa_tpu_torch.roaring import codec

    keys = np.arange(3 * 16, dtype=np.uint64)  # rows 0-2 × 16 containers
    data = codec.serialize_arrays(keys, words.reshape(48, 1024))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name, payload in (("data", data), ("cache", b"[0, 1, 2]")):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    buf.seek(0)
    return buf


def main_path(slices, seed, datadir, card):
    import torch

    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.holder import Holder

    need = slices * 3 * 16384 * 8 * 1.1
    free = shutil.disk_usage(os.path.dirname(datadir)).free
    check(free > need, f"{free / 1e9:.1f} GB free on disk, the data "
          f"directory needs {need / 1e9:.1f} GB")

    t0 = time.perf_counter()
    per_slice = np.zeros((len(QUERIES), slices), dtype=np.int64)
    holder = Holder(datadir).open()
    frame = holder.create_index("i").create_frame("f")
    view = frame.create_view_if_not_exists("standard")
    for s in range(slices):
        words = slice_words(seed, s)
        per_slice[:, s] = slice_counts(words)
        view.create_fragment_if_not_exists(s).read_from(backup_tar(words))
    holder.close()
    write_s = time.perf_counter() - t0
    print(f"main path: wrote {slices} slices ({slices * SLICE_WIDTH / 1e9:.2f}"
          f"B columns, {slices * 3 * 16384 * 8 / 1e9:.2f} GB of rows) "
          f"through Fragment.read_from in {write_s:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    holder = Holder(datadir).open()
    open_s = time.perf_counter() - t0
    check(holder.index("i").max_slice() == slices - 1, "max_slice")
    ex = Executor(holder)
    q_and = QUERIES[2][0]
    t0 = time.perf_counter()
    got = ex.execute("i", q_and)[0]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    want = [int(c) for c in per_slice.sum(axis=1)]
    check(got == want[2], f"{q_and}: {got} != oracle {want[2]}")

    def run_all(tag):
        for path in ("batched", "serial"):
            ex._force_path = path
            for (q, _), w in zip(QUERIES, want):
                t = time.perf_counter()
                got = ex.execute("i", q)[0]
                dt = time.perf_counter() - t
                check(got == w, f"{tag} {path} {q}: {got} != oracle {w}")
                print(f"  {tag} {path:7s} {dt * 1e3:9.2f} ms  {got:>13d}  "
                      f"{q}")
        ex._force_path = None

    run_all("query")

    lat = []
    for _ in range(100):
        t = time.perf_counter()
        got = ex.execute("i", q_and)[0]
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        check(got == want[2], "warm Count(Intersect) changed")
    lat_ms = np.asarray(lat) * 1e3

    # SetBit/ClearBit on one slice, each followed by a recount.
    s = slices // 2
    words = slice_words(seed, s)
    bit = int(np.flatnonzero(np.unpackbits(
        (~words[0]).view(np.uint8), bitorder="little"))[0])
    col = s * SLICE_WIDTH + bit
    for verb, value in (("SetBit", True), ("ClearBit", False)):
        res = ex.execute("i", f'{verb}(frame="f", rowID=0, columnID={col})')
        check(res == [True], f"{verb} at column {col} returned {res}")
        words[0][bit // 64] ^= np.uint64(1 << (bit % 64))
        per_slice[:, s] = slice_counts(words)
        want = [int(c) for c in per_slice.sum(axis=1)]
        run_all(verb.lower())
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    holder.close()
    check(all(launches.values()),
          f"a kernel never launched on the main path: {launches}")

    print(f"main path {card}: open {open_s:.2f} s, first Count(Intersect) "
          f"{first_s:.2f} s (stacks built), warm Count(Intersect) over "
          f"{slices} slices: p50 {np.percentile(lat_ms, 50):.3f} ms, p90 "
          f"{np.percentile(lat_ms, 90):.3f} ms, max {lat_ms.max():.3f} ms "
          f"(n=100, host clock to torch.cuda.synchronize()); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"launches {launches}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slices", type=int, default=MAIN_SLICES,
                    help="slices of 2^20 columns (default 9537 = 10.0B)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pilosa_tpu_torch.ops import loader

    # Phase 1: device.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; nvidia-smi: {smi}")

    # Phase 2: build.
    t0 = time.perf_counter()
    log = loader.build()
    parts = [f"{n} ({v['seconds']:.2f} s)" for n, v in log.items()]
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(parts)}")
    for name, v in log.items():
        regs = [ln.strip() for ln in v["output"].splitlines()
                if "registers" in ln]
        print(f"  {name}: {'; '.join(regs) or 'cached'}")

    # Phase 3: kernels against their plain versions.
    stats = kernel_checks(args.slices, card)

    # Phase 4: the main path.
    datadir = os.path.join(HERE, ".smoke_data")
    shutil.rmtree(datadir, ignore_errors=True)
    try:
        launches = main_path(args.slices, args.seed, datadir, card)
    finally:
        shutil.rmtree(datadir, ignore_errors=True)

    src = "pilosa_tpu_torch/csrc/popcount.cu"
    replaces = {"count_op_rows": "pilosa_tpu/ops/pallas_kernels.py:126",
                "count_rows": "pilosa_tpu/ops/pallas_kernels.py:195"}
    print(f"gpu: {smi}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"], "library_ms": None}
        for name in ("count_op_rows", "count_rows")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
