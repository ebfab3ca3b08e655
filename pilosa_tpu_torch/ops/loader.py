"""Build the CUDA sources under ``csrc/`` with nvcc and load them with
ctypes (a plain C interface: no PyTorch headers, so a build takes
seconds, not minutes).

Each source compiles to ``_build/lib<name>-<hash>.so`` inside the
package, where the hash covers the source text and the compiler flags:
an edited source builds anew, an unchanged one loads the existing
library. ``build()`` starts one nvcc process per source, all at once,
and waits for them together. Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# name -> source file under csrc/
SOURCES = {"popcount": "popcount.cu",
           "count_and_rows": "count_and_rows.cu",
           "containers": "containers.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_mu = threading.Lock()
_libs = {}          # name -> ctypes.CDLL
build_log = {}      # name -> {"seconds", "output", "path", "cached"}


def nvcc_path():
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then the toolkit's
    default install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled on a machine with "
        "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name):
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=None):
    """Compile every named source (default: all) whose library is not
    built yet, in parallel; raise if any compile fails. Returns
    ``build_log`` for the names asked."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if os.path.exists(target):
            build_log[name] = {"seconds": 0.0, "output": "",
                               "path": target, "cached": True}
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "output": text, "path": target, "cached": False}
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):"
                          f"\n{text}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return {n: build_log[n] for n in names}


def library(name):
    """The loaded ctypes library for one source, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _mu:
        lib = _libs.get(name)
        if lib is None:
            if not os.path.exists(build_log.get(name, {}).get("path", "")):
                build([name])
            lib = _libs[name] = ctypes.CDLL(build_log[name]["path"])
    return lib
