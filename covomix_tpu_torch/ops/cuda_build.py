"""Building the port's CUDA sources: nvcc for sm_90a into a shared library
with a plain C interface (loaded with ctypes by the kernel modules)."""

from __future__ import annotations

import glob
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def csrc(name: str) -> str:
    return os.path.join(PKG_DIR, "csrc", name)


def build_library(source: str, path: str, flags=()) -> str:
    """Compile `source` into the shared library `path` with nvcc unless it
    exists and is newer than the source and the headers (`*.cuh`) beside
    it. Returns nvcc's output ('' when the library was up to date); raises
    with that output if nvcc fails. Builds into distinct paths may run in
    parallel threads."""
    inputs = [source, *glob.glob(os.path.join(os.path.dirname(source), "*.cuh"))]
    if os.path.exists(path) and os.path.getmtime(path) >= max(map(os.path.getmtime, inputs)):
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); cannot build the CUDA kernel")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"   # concurrent builds never share a file
    # --split-compile=0: the kernels of one library are optimised on all CPU
    # cores at once (the dh-256 flash library, one thread: ~290 s of a
    # parallel build; split: ~107 s alone), with the same registers
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0", *flags, "-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, path)
    return log
