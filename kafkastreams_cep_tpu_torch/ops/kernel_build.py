"""Compile the CUDA sources of csrc/ into shared libraries.

A kernel source is compiled at first use, for the card with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v

or, with `target="cpu"`, with g++ under csrc/cpu_emu.h (threads for CUDA
threads, a barrier for __syncthreads), which the tests use to run a
kernel's own code on the CPU against its plain version. The library lands
in csrc/_build/ (listed in .gitignore), keyed by a hash of the source, the
flags and every csrc/ header the source includes, and beside it the
compiler's report (ptxas's registers and spills). Each library exports
plain C functions and is loaded with ctypes, so no PyTorch header is
compiled. A missing compiler or a failed
build raises RuntimeError. Every compiler run of this process is logged
in `BUILDS` as (stem, target, seconds); a cache hit runs nothing and logs
nothing.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: (stem, target, seconds) of every compiler run of this process.
BUILDS: List[Tuple[str, str, float]] = []

CPU_FLAGS = (
    "-x", "c++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
    "-fPIC", "-pthread", "-DNFA_CPU_EMU",
)


def compiler(target: str) -> Tuple[List[str], Tuple[str, ...]]:
    if target == "sm_90a":
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found (the CUDA toolkit is needed to build the kernels)")
        return [nvcc], NVCC_FLAGS
    if target == "cpu":
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        return [gxx], CPU_FLAGS
    raise ValueError(f"unknown target {target!r}")


def local_headers(src: str, seen: Optional[set] = None) -> List[str]:
    """The text of every csrc/ header `src` includes (`#include "..."`),
    and of the headers those include, each once."""
    seen = set() if seen is None else seen
    out = []
    for name in re.findall(r'#include "([^"]+)"', src):
        path = CSRC / name
        if name in seen or not path.exists():
            continue
        seen.add(name)
        text = path.read_text()
        out += [text] + local_headers(text, seen)
    return out


def compile_source(src: str, stem: str, target: str = "sm_90a",
                   build_dir: Optional[Path] = None) -> Path:
    """Compile one complete kernel source; returns the .so path. Cached by
    a hash of the source, the flags and the csrc/ headers it includes;
    concurrent builders of the same key are safe (atomic rename)."""
    cmd, flags = compiler(target)
    keyed = "\0".join([src, " ".join(flags)] + local_headers(src))
    key = hashlib.sha256(keyed.encode()).hexdigest()[:20]
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{stem}_{target}_{key}.so"
    if lib.exists():
        return lib
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cu = Path(tmp) / f"{stem}_{key}.cu"
        cu.write_text(src)
        tmp_lib = Path(tmp) / lib.name
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd + list(flags) + ["-I", str(CSRC), "-o", str(tmp_lib), str(cu)],
            capture_output=True, text=True,
        )
        BUILDS.append((stem, target, time.perf_counter() - t0))
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the {stem} kernel failed ({target}):\n{proc.stderr[-4000:]}"
            )
        (Path(tmp) / "log").write_text(proc.stdout + proc.stderr)
        os.replace(Path(tmp) / "log", lib.with_suffix(".log"))
        os.replace(tmp_lib, lib)
    return lib
