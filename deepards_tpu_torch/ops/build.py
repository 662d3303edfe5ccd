"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries are built at first use into ``_build/`` beside the
package (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("dtw", "lstm")

_loaded = {}
_lock = threading.Lock()


def cuda_tool(name):
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``, ...)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", name)
    if os.path.exists(path):
        return path
    path = shutil.which(name)
    if path is None:
        raise RuntimeError("{} not found (set CUDA_HOME)".format(name))
    return path


def library_path(name):
    """Where kernel ``name``'s library is (or will be) built."""
    return _target(name)[1]


def _target(name):
    src = CSRC / (name + ".cu")
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / "lib{}.{}.so".format(name, digest)


def _start(name):
    """Start nvcc for ``name`` if its library is missing: (tmp, out, proc)
    or None when the library is already built."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(".so.tmp{}".format(os.getpid()))
    proc = subprocess.Popen(
        [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return tmp, out, proc


def _finish(name, job, timeout=600):
    tmp, out, proc = job
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for {}:\n{}".format(name, log))
    os.replace(tmp, out)  # atomic: no process ever loads half a file
    return log


def build_all(names=KERNELS):
    """Build every named kernel library, one nvcc each, all in parallel.
    Returns {name: nvcc's output} for the libraries it built."""
    jobs = {}
    try:
        for name in names:
            job = _start(name)
            if job is not None:
                jobs[name] = job
        return {name: _finish(name, job) for name, job in jobs.items()}
    finally:  # leave no nvcc running when one of them failed
        for _, _, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name):
    """The ``ctypes.CDLL`` of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
