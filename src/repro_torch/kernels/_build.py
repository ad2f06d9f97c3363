"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded through
``ctypes``.  Sources are built from this package only; nothing is
fetched.  The libraries go to ``build/repro_torch_kernels/`` at the root
of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash
of the source, the headers it includes with ``#include "..."`` (such as
``csrc/tf32_mma.cuh``) and the flags, so an edited source or header
rebuilds.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them.

Nothing here runs at import: this module is imported on machines without
``nvcc`` or a card, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "matmul": CSRC / "matmul.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "decode_attention": CSRC / "decode_attention.cu",
    "softmax": CSRC / "softmax.cu",
    "ssd": CSRC / "ssd.cu",
}
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


_QUOTED_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def included_headers(path: Path) -> list:
    """The headers ``path`` includes with ``#include "..."``, found beside
    the file that includes them, and theirs in turn, each once, in the
    order they are first included."""
    seen, todo = [], [path]
    while todo:
        cur = todo.pop(0)
        for inc in _QUOTED_INCLUDE.findall(cur.read_bytes()):
            header = (cur.parent / inc.decode()).resolve()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in included_headers(src):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named kernel library that is not built yet, in parallel.

    Returns ``{name: seconds}`` for the libraries built by this call.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        final = library_path(n)
        tmp = final.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            final,
        )
    built: Dict[str, float] = {}
    errors = []
    for n, (p, tmp, final) in procs.items():
        log, _ = p.communicate()
        secs = time.perf_counter() - t0
        final.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n].name}:\n{log}")
            continue
        os.replace(tmp, final)
        built[n] = secs
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``, or '' if there is none."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")
