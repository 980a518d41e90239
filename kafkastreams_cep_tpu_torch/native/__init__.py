"""The host's native layer: the micro-batch packer, the match decoder and
the checkpoint checksum.

Three CPython extensions. Two are copied from the JAX package's native
layer: `packer.cc` packs per-key Event lists into [T, K] columns in one C
call per batch (field extraction, string tokens, topic ids, timestamp
rebase, validity, global event ids and the event registry); `decoder.cc`
turns the flat drain's chain-flatten table into `Sequence` objects
(`decode_matches_flat`) or straight into JSON or Arrow sink bytes
(`decode_matches_json`, `decode_matches_arrow`), and the pool drain's
ring and node planes into `Sequence` objects (`decode_matches`), in one
C call per drain. The third, `crc32c.cc`,
is the CRC-32C that seals checkpoint frames (state/serde.py), with the
SSE4.2 `crc32` instruction on x86-64 -- where the JAX package uses the
optional `google_crc32c` package.

Each is compiled at first use with

    g++ -O2 -shared -fPIC -std=c++17 -I<Python include dir>

into native/_build/ (listed in .gitignore), keyed by a hash of the
source, the flags and the interpreter, and imported from there. A
missing compiler or header, a failed build or a failed import raises
`NativeBuildError`: nothing falls back to the Python pack, decode or
checksum. The Python pack and decode stay in parallel/batched.py as the
reference the tests hold these to, and run only when a caller asks for
them (`native=False`); the Python checksum (`serde.crc32c_python`) is
the tests' reference only.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

NATIVE = Path(__file__).resolve().parent
BUILD_DIR = NATIVE / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_mods: Dict[str, ModuleType] = {}


class NativeBuildError(RuntimeError):
    """A native extension could not be built or imported."""


def python_include() -> str:
    """The running interpreter's C header directory (must hold Python.h)."""
    return sysconfig.get_paths()["include"]


def build_ext(name: str, cxx: Optional[str] = None,
              build_dir: Optional[Path] = None) -> Path:
    """Compile native/<name>.cc and return the extension's path.

    Cached by a hash of the source, the flags and the interpreter;
    concurrent builders of the same key are safe (atomic rename). `cxx`
    names the compiler (default: g++ on PATH). Raises NativeBuildError."""
    compiler = cxx if cxx is not None else shutil.which("g++")
    if compiler is None:
        raise NativeBuildError(f"g++ not found: cannot build the native {name}")
    include = python_include()
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise NativeBuildError(f"Python.h not found in {include}: cannot build the native {name}")
    src = NATIVE / f"{name}.cc"
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    keyed = "\0".join([src.read_text(), " ".join(CXX_FLAGS), include, sys.version])
    key = hashlib.sha256(keyed.encode()).hexdigest()[:20]
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"_{name}_{key}{suffix}"
    if so.exists():
        return so
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_so = Path(tmp) / so.name
        cmd = [compiler, *CXX_FLAGS, f"-I{include}", str(src), "-o", str(tmp_so)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise NativeBuildError(f"building the native {name} failed: {exc}") from exc
        if proc.returncode != 0:
            raise NativeBuildError(
                f"building the native {name} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp_so, so)
    return so


def load_ext(name: str) -> ModuleType:
    """The compiled `_<name>` module, built at first use. Raises
    NativeBuildError."""
    with _lock:
        mod = _mods.get(name)
        if mod is None:
            so = build_ext(name)
            # The module name must match the PyInit__<name> symbol.
            spec = importlib.util.spec_from_file_location(f"_{name}", so)
            if spec is None or spec.loader is None:
                raise NativeBuildError(f"cannot import the native {name} from {so}")
            mod = importlib.util.module_from_spec(spec)
            try:
                spec.loader.exec_module(mod)
            except ImportError as exc:
                raise NativeBuildError(f"importing the native {name} failed: {exc}") from exc
            _mods[name] = mod
    return mod


def load_packer() -> ModuleType:
    return load_ext("packer")


def load_decoder() -> ModuleType:
    return load_ext("decoder")


def load_crc32c() -> ModuleType:
    return load_ext("crc32c")
