"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``. The build runs at first use,
into ``build/repro_torch/`` at the root of the checkout. A library's file
name carries a hash of its source and of the nvcc command, so an edited
source is rebuilt and an unchanged one is loaded as it is.

    python -m repro_torch.kernels.build [--ptxas] [name ...]

builds the named sources (default: all), and with ``--ptxas`` compiles
them once more with ``-Xptxas -v`` and prints each kernel's registers,
shared memory and spills.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else /usr/local/cuda's, else the PATH's."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc on ``csrc/{name}.cu`` unless its library is built: into a
    file of this process's own, renamed into place by :func:`_finish`, so
    two processes never load a half-written library."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish(job) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                           f"{out.name}:\n{log}")
    os.replace(tmp, out)


def build_all(names) -> None:
    """Compile every library of ``names`` that is not built yet, with one
    nvcc per source, all started together; raises if any fails (after all
    have ended)."""
    jobs = [job for job in map(_start, names) if job is not None]
    errors = []
    for job in jobs:
        try:
            _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/{name}.cu``, compiling it first if it
    is not built yet."""
    job = _start(name)
    if job is not None:
        _finish(job)
    return ctypes.CDLL(str(library_path(name)))


def ptxas_report(name: str) -> str:
    """ptxas's resource report (-Xptxas -v) for ``csrc/{name}.cu``,
    compiled into a throwaway object under the build directory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.ptxas.{os.getpid()}.o"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared",)]
    try:
        proc = subprocess.run(
            [nvcc_path(), *flags, "-c", "-Xptxas", "-v", "-o", str(out),
             str(CSRC / f"{name}.cu")], capture_output=True, text=True)
    finally:
        out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return proc.stderr


def main(argv) -> None:
    report = "--ptxas" in argv
    names = [a for a in argv if a != "--ptxas"] or sorted(
        p.stem for p in CSRC.glob("*.cu"))
    build_all(names)
    print(f"built {', '.join(names)} into {BUILD_DIR}")
    if report:
        for name in names:
            print(f"--- {name}.cu\n{ptxas_report(name)}")


if __name__ == "__main__":
    main(sys.argv[1:])
