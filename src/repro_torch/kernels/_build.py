"""Builds the CUDA sources under ``src/repro_torch/csrc/`` with ``nvcc``
at first use and binds them with ``ctypes``.

Each ``<name>.cu`` becomes ``build/kernels/lib<name>.<key>.so`` at the
root of the checkout, compiled for ``sm_90a``; ``<key>`` is a hash of the
source, the headers beside it (``*.cuh``) and the flags, so a library is
rebuilt exactly when one of them changed, and nvcc's ptxas report is
kept beside it as ``.log``. The sources expose plain C functions, so no
PyTorch header is compiled and a build takes seconds. Nothing is built
when this module is imported; ``build_all`` starts one ``nvcc`` per
source that lacks its library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
            "repro_torch are built from source at first use")
    return str(path)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
    key = hashlib.sha256(b"".join(parts)
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}.{key}.so"


def report(name: str) -> str:
    """nvcc's output (the ptxas register, shared memory and spill lines)
    of the build of ``csrc/<name>.cu`` that ``load`` uses."""
    return _lib_path(name).with_suffix(".log").read_text()


def build_all(names=None) -> dict[str, str]:
    """Compile every source that lacks its library in parallel, one
    ``nvcc`` each; returns {name: nvcc output} of those built. Raises if
    any build fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, outputs = {}, {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        outputs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{out}")
        else:
            _lib_path(name).with_suffix(".log").write_text(out)
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


_count_lock = threading.Lock()


def count_launch(launches: dict, name: str) -> None:
    """One more launch of ``name`` in a wrapper module's ``LAUNCHES``;
    under a lock, since the sharded engine launches from one thread a
    shard."""
    with _count_lock:
        launches[name] += 1


def runs_plain(*tensors) -> bool:
    """Whether a wrapper runs its plain version on these tensors: all on
    the CPU, or all on the meta device (a dry run, which computes shapes
    and dtypes only). A CUDA tensor launches the kernel or raises."""
    kinds = {t.device.type for t in tensors}
    return kinds == {"cpu"} or kinds == {"meta"}


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")
