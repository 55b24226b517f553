"""Build and load the port's CUDA C++ kernels.

Each source under a kernel folder's ``csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded
with ``ctypes``.  The build happens at first use (never at import) into
``_build/`` beside the sources; the library's name carries a hash of its
source, of every header it includes by a quoted relative path (followed
recursively: the Hopper helpers of ``kernels/csrc/sm90.cuh`` are shared by
two sources) and of the flags, so an edited source or header is rebuilt.
Every missing library is compiled at once, one ``nvcc`` process per
source, all in parallel.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_LOG: Dict[str, str] = {}   # nvcc/ptxas output of each fresh build

# name -> (source file, library file)
Jobs = Dict[str, Tuple[Path, Path]]


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump): on PATH, else in
    $CUDA_HOME/bin."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: put it on PATH or set "
                           "CUDA_HOME")
    return path


def sources(source: Path) -> List[Path]:
    """``source`` and every file it includes by a quoted path, relative to
    the including file, recursively; each once, in the order first met.
    A quoted include that names no such file is left to nvcc."""
    found: List[Path] = []

    def visit(path: Path) -> None:
        path = path.resolve()
        if path in found:
            return
        found.append(path)
        for m in _QUOTED_INCLUDE.finditer(path.read_bytes()):
            inc = path.parent / m.group(1).decode()
            if inc.is_file():
                visit(inc)
    visit(source)
    return found


def lib_path(source: Path, build_dir: Path) -> Path:
    """The library built from ``source``: named by a hash of the text of
    the source and of every header it includes (``sources``), and of the
    flags."""
    h = hashlib.sha256()
    for path in sources(source):
        text = path.read_bytes()
        h.update(len(text).to_bytes(8, "little"))
        h.update(text)
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def sass_counts(lib: Path, opcodes: Iterable[str]) -> Dict[str, int]:
    """How many instructions of each opcode (``HGMMA``, ``UTMALDG``, ...)
    the machine code of a built library holds (``cuobjdump -sass``)."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", out)) for op in opcodes}


def jobs(csrc: Path, build_dir: Path, sources: Dict[str, str]) -> Jobs:
    """The build jobs of one kernel folder: name -> (source, library)."""
    return {name: (csrc / src, lib_path(csrc / src, build_dir))
            for name, src in sources.items()}


def compile_all(todo: Jobs) -> None:
    """Compile every job whose library does not exist yet, all in
    parallel.  Raises with the compiler's output on failure."""
    todo = {n: (s, p) for n, (s, p) in todo.items() if not p.exists()}
    if not todo:
        return
    nvcc = _tool("nvcc")
    procs = {}
    for name, (src, path) in todo.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def raise_on(name: str, error_string, err: int) -> None:
    """Raise if a launch returned a CUDA error (``error_string`` is the
    library's ``*_error_string`` function)."""
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
