"""Build and load the port's CUDA kernels (``frido_tpu_torch/csrc/*.cu``).

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is built when a
module is imported: the first CUDA launch of a kernel builds it, and
:func:`build` builds several at once, one ``nvcc`` process each, all
started together. A source may include the shared headers of ``csrc/``
(``*.cuh``); they are part of every library's hash. A source that calls a
toolkit library is linked with it (:data:`LINK`: ``jpeg_decode`` with
nvJPEG, from the toolkit's ``lib64``, which is also the library's run
path). Builds and loads are serialised within a process: the data
loader's threads may all reach the first JPEG decode at once. A launch
goes to the runtime's current device, on the stream :func:`raw_stream`
gives, inside :func:`device_context`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "vq_argmin", "group_norm", "smalls_attention",
           "conv3x3", "jpeg_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# toolkit libraries a source links with
LINK = {"jpeg_decode": ("-lnvjpeg",)}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def _cuda_home() -> pathlib.Path:
    return pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def _link_flags(name: str) -> tuple:
    libs = LINK.get(name, ())
    if not libs:
        return ()
    lib64 = _cuda_home() / "lib64"
    return ("-L", str(lib64), "-Xlinker", f"-rpath={lib64}", *libs)


def _nvcc() -> str:
    cand = _cuda_home() / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (registers, shared memory and spills per kernel). Raises with the
    compiler's output if any build fails.
    """
    with _LOCK:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *_link_flags(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _LOADED[name] = lib
    return lib


def device_context(device: torch.device):
    """The device's context for a launch, entered only when the tensors lie
    on another device than the runtime's current one."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The device's current CUDA stream as an int, without making a
    ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)
