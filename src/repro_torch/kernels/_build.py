"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its
own by ``nvcc`` into a shared library that :mod:`ctypes` loads (no
PyTorch headers, so a build takes seconds).  All sources are compiled in
parallel at first use, into ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout, where ``<hash>`` covers every source, every shared
header (``csrc/*.cuh``) and the compiler flags — an edited source or
header rebuilds, an unchanged tree loads the libraries already built.  The compiler's ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside each library as
``<name>.log``.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: one shared library per source file
SOURCES = {
    "fusemax_prefill": "fusemax_prefill.cu",
    "decode_partials": "decode_partials.cu",
    "paged_decode_partials": "paged_decode_partials.cu",
    "mla_paged_decode_partials": "mla_paged_decode_partials.cu",
    "latent_decode_partials": "latent_decode_partials.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the CUDA "
        "kernels build only on a machine with the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        h.update(name.encode())
        h.update((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, all at once; return
    {name: library path}.  Raises :class:`KernelBuildError` with the
    compiler's output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [n for n, p in libs.items() if not p.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        # compile to a temporary name, then rename: a concurrent reader
        # never sees a half-written library
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                                   dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[name]} (exit {proc.returncode})\n"
                          f"{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def _loaded() -> dict[str, ctypes.CDLL]:
    return {name: ctypes.CDLL(str(path))
            for name, path in build_all().items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every kernel at first use)."""
    return _loaded()[name]


def timed_build() -> float:
    """Build (or find built) and load every kernel; return the seconds."""
    t0 = time.perf_counter()
    _loaded()
    return time.perf_counter() - t0


def parse_ptxas(log: str) -> dict[str, str]:
    """{instantiation (its mangled template arguments): ptxas resource
    line (registers, barriers, stack, spills)} of one ``-Xptxas -v``
    log."""
    entries: dict[str, str] = {}
    current, spills = None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                      r"I(\w+?)EEv", ln)
        if m:
            current, spills = f"{m.group(1)}<{m.group(2)}>", ""
        elif current and "spill" in ln:
            spills = "; " + ln.strip()
        elif current and "Used" in ln and "registers" in ln:
            entries[current] = ln.split(":", 1)[1].strip() + spills
            current = None
    return entries


def ptxas_report() -> dict[str, dict[str, str]]:
    """Per library, :func:`parse_ptxas` of the last build's log."""
    out: dict[str, dict[str, str]] = {}
    for name in SOURCES:
        log = build_dir() / f"{name}.log"
        out[name] = parse_ptxas(log.read_text() if log.exists() else "")
    return out
