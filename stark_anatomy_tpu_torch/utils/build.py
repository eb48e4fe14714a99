"""Build the port's native libraries from their sources, at first use.

One compiler call per source writes a shared library with a plain C
interface into ``_build/`` (git-ignored), named by a hash of the source,
the headers it includes, the flags and the compiler's path, so a changed source or flag builds anew
and an unchanged one is loaded as it is.  The calls of one ``build_all``
run side by side.  A build goes to a temporary file that is renamed into
place, so processes that build the same library at once do not see each
other's half-written files.  A failed build raises: nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, NamedTuple, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")


class Job(NamedTuple):
    """One library: ``compiler flags -o <lib> source``; ``headers`` are the
    files the source includes, hashed into the library's name with it."""

    stem: str
    compiler: str
    flags: Tuple[str, ...]
    source: str
    headers: Tuple[str, ...] = ()


def library_path(job: Job) -> str:
    src = b""
    for path in (job.source, *job.headers):
        with open(path, "rb") as f:
            src += f.read() + b"\0"
    key = hashlib.sha256(
        src + " ".join(job.flags).encode() + b"\0" + os.path.realpath(job.compiler).encode()
    ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{job.stem}_{key}.so")


def build_all(jobs: Sequence[Job]) -> Tuple[Dict[str, str], str]:
    """({stem: library path}, the compilers' output) for ``jobs``; the
    libraries not built yet are compiled in parallel."""
    paths = {job.stem: library_path(job) for job in jobs}
    running: List[Tuple[Job, str, subprocess.Popen]] = []
    for job in jobs:
        lib = paths[job.stem]
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [job.compiler, *job.flags, "-o", tmp, job.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((job, tmp, proc))
    log, failed = [], []
    for job, tmp, proc in running:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(job.compiler)} {job.source} failed "
                          f"({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[job.stem])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths, "".join(log)


def host_compiler() -> str:
    """The host C++ compiler of the native host libraries (N1, N2):
    $CXX, else c++, else g++."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found")
