"""Build and load the port's CUDA C++ kernels.

Each source under a kernel folder's ``csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded
with ``ctypes``.  The build happens at first use (never at import) into
``_build/`` beside the sources; the library's name carries a hash of its
source, of every header it includes by a quoted relative path (followed
recursively: the Hopper helpers of ``kernels/csrc/sm90.cuh`` are shared by
two sources) and of the flags, so an edited source or header is rebuilt.
Every missing library is compiled at once, one ``nvcc`` process per
source, all in parallel; the compiler's report (``-Xptxas -v``: each
kernel's registers and spills) is kept beside the library.
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


def _sass(lib: Path) -> str:
    return subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def _count(text: str, opcodes: Iterable[str]) -> Dict[str, int]:
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in opcodes}


def sass_counts(lib: Path, opcodes: Iterable[str]) -> Dict[str, int]:
    """How many instructions of each opcode (``HGMMA``, ``UTMALDG``, ...)
    the machine code of a built library holds (``cuobjdump -sass``)."""
    return _count(_sass(lib), opcodes)


def split_functions(text: str, header: str) -> Dict[str, str]:
    """The text after each line holding ``header`` followed by a symbol,
    up to the next such line, keyed by that symbol."""
    parts = re.split(rf"^.*?{header}\s*(\S+).*$", text, flags=re.M)
    return {parts[i]: parts[i + 1] for i in range(1, len(parts) - 1, 2)}


def sass_counts_by_function(lib: Path, opcodes: Iterable[str]
                            ) -> Dict[str, Dict[str, int]]:
    """``sass_counts`` for each kernel of the library apart, keyed by its
    mangled name (a template instantiation's name holds its arguments,
    ``...ILi256E...`` for 256)."""
    return {name: _count(body, opcodes) for name, body in
            split_functions(_sass(lib), "Function :").items()}


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """The registers and the spill store and load bytes of each function
    that ``ptxas -v`` reported in a build log (``build_log``), keyed by
    its mangled name."""
    out = {}
    for name, body in split_functions(log, "Function properties for").items():
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      body)
        r = re.search(r"Used (\d+) registers", body)
        if m and r:
            out[name] = {"registers": int(r.group(1)),
                         "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))}
    return out


def build_log(lib: Path) -> str:
    """The nvcc / ptxas output of the build that made ``lib``, kept beside
    it (``compile_all``), so it is there for a library built earlier."""
    return lib.with_suffix(".log").read_text()


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
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def raise_on(name: str, error_string, err: int) -> None:
    """Raise if a launch returned a CUDA error (``error_string`` is the
    library's ``*_error_string`` function)."""
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
