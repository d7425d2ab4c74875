"""Compile the port's native sources into ``glsdet_tpu_torch/_build/``.

A library is named after a hash of its sources and commands, so a changed
source builds anew and an unchanged one is reused.  Every source compiles
on its own, all at once, and the objects link into the library under a
temporary name that is renamed into place, so a process never loads a
half-written library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
_lock = threading.Lock()


def build_shared(name: str, sources: Sequence[str], compile_cmd: Sequence[str],
                 link_cmd: Sequence[str], deps: Sequence[str] = ()) -> str:
    """Build ``sources`` into one shared library unless a library of the
    same sources, headers (``deps``) and commands exists; returns its
    path.  Each source runs ``compile_cmd + ["-c", src, "-o", obj]`` (all
    started together), then ``link_cmd + objects + ["-o", lib]`` links
    them."""
    h = hashlib.sha256(" ".join([*compile_cmd, "|", *link_cmd]).encode())
    for src in (*sources, *deps):
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    with _lock:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
                objs = [os.path.join(tmp_dir, f"{i}.o")
                        for i in range(len(sources))]
                procs = [subprocess.Popen(
                    [*compile_cmd, "-c", src, "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                    for src, obj in zip(sources, objs)]
                logs = [p.communicate() for p in procs]
                for src, p, (so, se) in zip(sources, procs, logs):
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"building {name} failed on {src}:\n{so}{se}")
                tmp = os.path.join(tmp_dir, "lib.so")
                res = subprocess.run([*link_cmd, *objs, "-o", tmp],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"linking {name} failed:\n"
                                       f"{res.stdout}{res.stderr}")
                os.replace(tmp, out)
    return out
