"""Builds the JAX package's UFP packing library
(``glsdet_tpu/native/libufp.so``) once, before any test file that loads
it is collected.

pytest collects this directory before ``tests/test_native_packing.py``
(a directory's entries are taken in name order), and under pytest-xdist
every worker collects every file.  ``glsdet_tpu.native`` compiles its
library at first use with g++ straight to its final path, and
``test_native_packing.py`` decides at import whether to skip its nine
tests ("no C++ toolchain").  In a fresh checkout the six workers each ran
g++ into the same file at once; a worker that loaded it half written
marked its build failed, and when that worker ran the file the nine
tests skipped, so the count of passes of one tree moved by nine between
runs.  Here the first worker to arrive compiles the same command to a
temporary name under a file lock and renames it into place; the others
wait on the lock and find it built, and the JAX package's loader then
finds a library newer than its source and loads it without compiling.
The command is read from ``glsdet_tpu/native/__init__.py: _build``'s
source, not copied.  Without g++ nothing is built and that file skips as
before.

This holds only when pytest collects ``tests/`` as a directory, as the
tier-1 command does: a run that names test files one by one does not
collect this file first, and the nine tests may skip again.
"""

import ast
import fcntl
import os
import shutil
import subprocess
from typing import List, Optional

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(ROOT, "glsdet_tpu", "native", "packing.cpp")
SO = os.path.join(ROOT, "glsdet_tpu", "native", "libufp.so")
LOADER = os.path.join(ROOT, "glsdet_tpu", "native", "__init__.py")
LOCK = os.path.join(ROOT, "glsdet_tpu_torch", "_build", "libufp.lock")


def _built() -> bool:
    return (os.path.exists(SO)
            and os.path.getmtime(SO) >= os.path.getmtime(SRC))


def loader_command(out: str) -> Optional[List[str]]:
    """The argument list ``glsdet_tpu.native._build`` hands to
    ``subprocess.run``, read from its source, with its ``_SRC`` as
    ``SRC`` and its ``_SO`` as ``out``; None where that call is not found."""
    with open(LOADER) as f:
        tree = ast.parse(f.read())
    names = {"_SRC": SRC, "_SO": out}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name == "_build"):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and ast.unparse(node.func) == "subprocess.run"
                    and node.args and isinstance(node.args[0], ast.List)):
                cmd = []
                for arg in node.args[0].elts:
                    if isinstance(arg, ast.Constant):
                        cmd.append(arg.value)
                    elif isinstance(arg, ast.Name) and arg.id in names:
                        cmd.append(names[arg.id])
                    else:
                        return None
                return cmd
    return None


def build_packing_library() -> None:
    """``glsdet_tpu.native._build``'s g++ command, once across processes,
    renamed into place."""
    if shutil.which("g++") is None:
        return
    tmp = f"{SO}.{os.getpid()}.tmp"
    cmd = loader_command(tmp)
    if cmd is None:
        return
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _built():
            return
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, SO)
        except (OSError, subprocess.CalledProcessError):
            if os.path.exists(tmp):
                os.remove(tmp)


build_packing_library()


def test_packing_library_is_built_once_and_loads():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    from glsdet_tpu.native import native_available

    # the loader's own command, compiling its source to its library
    cmd = loader_command(SO)
    assert cmd is not None and cmd[0] == "g++"
    assert SRC in cmd and cmd[-1] == SO
    assert _built()
    assert native_available()
