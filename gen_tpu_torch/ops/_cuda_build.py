"""Build generated CUDA sources with ``nvcc`` and bind them with ``ctypes``.

No counterpart in gen_tpu (Pallas kernels compile inside ``jit``). Every
fused kernel of the port is a CUDA C++ source with a plain C entry point,
specialized per model by splicing in the staged program. This module
compiles such a source for ``sm_90a`` into ``_build/`` next to this file
(gitignored), keyed by a hash of the source and the flags, and loads it;
ptxas's report stays beside the library (:func:`ptxas_report`). A
source that includes PyTorch's headers would take minutes to build; these
take seconds. Several sources build in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
BUILD_LOG: List[Tuple[str, float, str]] = []   # (hash, seconds, ptxas report)
_LIBS: Dict[str, ctypes.CDLL] = {}

# a C entry point's signature: {function name: [ctypes argument types]};
# every entry point returns cudaGetLastError() as an int
Signatures = Dict[str, Sequence]


def csrc_text(path: Path) -> str:
    """The text of the kernel source ``path`` with each marker line ``//
    @@INCLUDE <file>@@`` replaced by the text of ``<file>`` from the same
    directory (the sources are compiled in the build directory, where no
    relative ``#include`` would be found, and the build hashes the spliced
    text)."""
    return re.sub(r"// @@INCLUDE (\S+)@@\n",
                  lambda m: csrc_text(path.parent / m.group(1)),
                  path.read_text())


def nvcc() -> str:
    """The CUDA toolkit's nvcc, located as torch.utils.cpp_extension
    locates it (``CUDA_HOME``, then nvcc on the PATH, then the default
    install prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME
    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError(f"no CUDA toolkit found (CUDA_HOME={CUDA_HOME!r})")
    return path


def source_hash(src: str) -> str:
    return hashlib.sha256((src + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]


def _load(so: Path, signatures: Signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all(jobs: Sequence[Tuple[str, str, Signatures]]
              ) -> List[ctypes.CDLL]:
    """Compile (once per source) and load each ``(name, source,
    signatures)``; the ``nvcc`` processes of the sources not built yet run
    at the same time. Raises with the compiler's output if one fails."""
    pending = []
    for name, src, _ in jobs:
        h = source_hash(src)
        so = BUILD_DIR / f"{name}_{h}.so"
        if h in _LIBS or so.exists() or any(p[0] == h for p in pending):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = BUILD_DIR / f"{name}_{h}.cu"
        cu.write_text(src)
        tmp = BUILD_DIR / f"{name}_{h}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(cu)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        pending.append((h, cu, tmp, so, proc, time.perf_counter()))
    failures = []
    for h, cu, tmp, so, proc, t0 in pending:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {cu}:\n{err}")
            continue
        so.with_suffix(".ptxas").write_text(err)
        os.replace(tmp, so)
        BUILD_LOG.append((h, time.perf_counter() - t0, err))
    if failures:
        raise RuntimeError("\n".join(failures))
    libs = []
    for name, src, signatures in jobs:
        h = source_hash(src)
        if h not in _LIBS:
            _LIBS[h] = _load(BUILD_DIR / f"{name}_{h}.so", signatures)
        libs.append(_LIBS[h])
    return libs


def ptxas_report(name: str, src: str) -> Optional[str]:
    """ptxas's report (``-v``: registers, spills, stack frame) of the
    library built from ``(name, src)``, whether this process built it or
    found it built; None if there is none."""
    rep = BUILD_DIR / f"{name}_{source_hash(src)}.ptxas"
    return rep.read_text() if rep.exists() else None


def build(name: str, src: str, signatures: Signatures) -> ctypes.CDLL:
    """:func:`build_all` of one source."""
    return build_all([(name, src, signatures)])[0]


def check_launch(rc: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error: a launch that is
    refused never runs, and a later synchronize would not report it."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")
