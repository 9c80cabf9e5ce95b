"""Kernel backend: a hand-written CUDA kernel on the card, its plain twin
on the CPU — the PyTorch twin of the JAX package's ``kernels/interpret.py``.

There the backend chose Pallas interpret mode. Here the device of the
tensors decides, and nothing else:

* a CUDA tensor launches the hand kernel, or raises — never a silent twin;
* a CPU tensor takes the plain PyTorch twin in :mod:`repro_torch.kernels.ref`.

The kernels are CUDA C++ under ``csrc/``, one source per kernel, each with
a plain C entry point that launches on the caller's stream and returns
``cudaGetLastError()``. They are compiled at first use by ``nvcc`` for
``sm_90a`` — one process per source, all started together — into
``build/repro_torch_kernels/<hash of sources and flags>/`` at the
repository root, and loaded with ``ctypes``. Nothing is built when a module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bm25_block", "topk", "bm25_pruned")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# IEEE division (nvcc's default -prec-div=true) and no FMA contraction: each
# arithmetic step rounds once, as the eager twins' ops do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (restype, argtypes) of every C entry point, per library
SIGNATURES = {
    "bm25_block": {
        "bm25_block_scores_launch": (_I, [_P, _P, _P, _P, _LL, _I, _I, _F, _F, _F, _P]),
    },
    "topk": {
        "topk_rounds_launch": (_I, [_P, _P, _LL, _LL, _I, _I, _I, _I, _P, _P, _P]),
    },
    "bm25_pruned": {
        "bm25_pruned_smem_bytes": (_LL, [_I, _I, _I]),
        "bm25_pruned_accumulate_launch": (_I, [_P] * 8 + [_I] * 6 + [_F] * 4 + [_P]),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True → launch the hand kernel (CUDA tensors); False → the plain twin
    (CPU tensors). Mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no twin for device {device}")


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """An entry point's ``device=``: ``None`` means the card. Without a card
    that raises — only an explicit ``device="cpu"`` runs the twins."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain twins")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source that is not built yet, in parallel; return the
    directory. Each library lands under a temporary name and is renamed into
    place, so concurrent processes never load a half-written file."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_error_string.argtypes = [ctypes.c_int]
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a launch the runtime refused (the C entry points return
    ``cudaGetLastError()`` right after their launches)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card: kernels launch there and
    never synchronise."""
    return torch.cuda.current_stream(t.device).cuda_stream


def f32(x) -> float:
    """A scalar parameter as the float32 value the kernels compute with
    (0-d tensors are read back to the host once)."""
    return float(torch.as_tensor(x, dtype=torch.float32).item())
