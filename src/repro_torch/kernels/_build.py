"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. The
build happens at first use, never at import: the CPU tests import every
module on machines without ``nvcc``. Libraries are cached under
``kernels/build/`` (listed in ``.gitignore``) by a hash of the sources, so
an edited source is rebuilt and an unchanged one is not. :func:`build_all`
starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("lbgm_projection", "lbgm_sparse_decision", "lbgm_dequant_accum",
           "flash_attention", "flash_attention_sm90", "rwkv6_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas registers, shared memory and spills per kernel)
#: of each library this process built
BUILD_LOGS: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc failed or is missing; carries the compiler's output."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelBuildError(
            "no CUDA toolkit found (CUDA_HOME unset and no nvcc on PATH); "
            "the port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_paths = (tmp, out)  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    tmp, out = proc.out_paths  # type: ignore[attr-defined]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    BUILD_LOGS[name] = log
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns ``name -> .so path``."""
    names = list(names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {n: _start(n) for n in names if not _lib_path(n).exists()}
        errors = []
        for n, p in procs.items():
            try:
                _finish(n, p)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return {n: _lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _libs[name] = lib
    return lib


# ----------------------------------------------------------- launch side

#: launches per kernel wrapper; a wrapper adds one where it launches its
#: kernel and nowhere else (the CPU path counts nothing)
LAUNCHES: Dict[str, int] = {"lbgm_projection": 0, "lbgm_sparse_decision": 0,
                            "lbgm_sparse_decision_two_pass": 0,
                            "lbgm_dequant_accum": 0, "flash_attention": 0,
                            "rwkv6_scan": 0}


#: the same launches by the shape of the call (a wrapper's own key: the
#: decision's (B, size, nb, block, kb), the projection's leaf table, the
#: fold's (C, nb, block, kb), flash's (B, Tq, Tk, Hq, Hkv, hd), the scan's
#: (B, T, H, hd))
LAUNCH_SHAPES: Dict[str, Dict[tuple, int]] = {k: {} for k in LAUNCHES}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k] = {}


def count_launch(name: str, shape: tuple) -> None:
    """One launch of ``name``'s kernel, at ``shape``."""
    LAUNCHES[name] += 1
    by_shape = LAUNCH_SHAPES[name]
    by_shape[shape] = by_shape.get(shape, 0) + 1


_tickets: Dict[tuple, object] = {}


def tickets(name: str, device, n: int):
    """``n`` int32 counters on ``device`` for ``name``'s kernel, zero
    between its calls: the kernel's last CTA of a client finds itself by
    one and sets it back to 0. Kept across calls (made once, zeroed once,
    grown as needed), so a call launches nothing but its kernel; calls of
    one kernel on one device are ordered on the current stream."""
    import torch
    key = (name, str(device))
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


#: devices whose tensors take a kernel's plain version: the CPU, and meta
#: (shapes only: the dry run counts the plain version's operations)
PLAIN_DEVICES = ("cpu", "meta")


def check_card(*tensors) -> None:
    """Raise unless every tensor lies on one CUDA device of compute
    capability 9.0 (Hopper) — the only card the kernels are built for.
    There is no fallback to the plain version for a CUDA tensor."""
    import torch
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise RuntimeError(
            f"the port's kernels take CPU or meta tensors (plain version) "
            f"or CUDA tensors (hand-written kernel); got device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA tensor was given but CUDA is not "
                           "available on this machine")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (H100/H200); "
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{rc}")
