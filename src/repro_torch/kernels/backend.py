"""Kernel backend: a hand-written CUDA kernel on the card, its plain twin
on the CPU — the PyTorch twin of the JAX package's ``kernels/interpret.py``.

There the backend chose Pallas interpret mode. Here the device of the
tensors decides, and nothing else:

* a CUDA tensor launches the hand kernel, or raises — never a silent twin;
* a CPU tensor takes the plain PyTorch twin in :mod:`repro_torch.kernels.ref`;
* a meta tensor (the dry run's abstract trace) computes nothing: the
  wrapper returns empty meta outputs by the shape rule written beside it
  and records the call's operations and bytes (:func:`record_costs`).

The kernels are CUDA C++ under ``csrc/``, one source per kernel, each with
a plain C entry point that launches on the caller's stream and returns
``cudaGetLastError()``. They are compiled at first use by ``nvcc`` for
``sm_90a`` — one process per source, all started together — into
``build/repro_torch_kernels/<hash of sources and flags>/`` at the
repository root, and loaded with ``ctypes``. Nothing is built when a module
is imported.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bm25_block", "topk", "bm25_pruned", "dot_topk", "flash_attention",
           "flash_attention_bf16", "embedding_bag")
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
        "bm25_block_impacts_launch": (_I, [_P] * 6 + [_LL, _I, _I, _I, _F, _F, _F, _P]),
    },
    "topk": {
        "topk_smem_bytes": (_LL, [_I, _I]),
        "topk_select_launch": (_I, [_P, _P, _LL, _LL, _I, _I, _I, _I, _P, _P, _P]),
    },
    "bm25_pruned": {
        "bm25_pruned_theta_smem_bytes": (_LL, [_I] * 3),
        "bm25_pruned_range_docs": (_I, [_I, _I]),
        "bm25_pruned_launch": (_I, [_P] * 17 + [_I] * 8 + [_F] * 4 + [_P]),
    },
    "dot_topk": {
        "dot_topk_tiles_launch": (_I, [_P, _P, _I, _LL, _I, _I, _I, _I, _P, _P, _P]),
    },
    "flash_attention": {
        "flash_attention_launch": (_I, [_P] * 5 + [_I] * 10 + [_F, _P]),
    },
    "flash_attention_bf16": {
        "flash_attention_tc_launch": (_I, [_P] * 5 + [_I] * 9 + [_F, _P]),
        "flash_attention_split_launch": (_I, [_P] * 7 + [_I] * 12 + [_F, _P]),
    },
    "embedding_bag": {
        "embedding_bag_launch": (_I, [_P] * 4 + [_LL, _I, _I, _I, _P]),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def route(*tensors: torch.Tensor) -> str:
    """Where a wrapper's call goes, from its tensors' one device: ``"cuda"``
    launches the hand kernel, ``"cpu"`` takes the plain twin, ``"meta"``
    computes nothing — the wrapper returns empty meta outputs of the
    kernel's shapes and dtypes and records the call's cost
    (:func:`meta_result`), for the dry run's abstract trace. Mixed or other
    devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type in ("cuda", "cpu", "meta"):
        return device.type
    raise ValueError(f"no kernel and no twin for device {device}")


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call on meta tensors: its work under the bound's rule
    (each input read once, each output written once; the operations its
    inputs need)."""

    name: str
    flops: float
    bytes: float


_COSTS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_kernel_costs",
                                                        default=None)


@contextlib.contextmanager
def record_costs():
    """Collect a :class:`KernelCost` for every kernel call on meta tensors
    inside the block, in call order, into the list it yields."""
    log: list[KernelCost] = []
    token = _COSTS.set(log)
    try:
        yield log
    finally:
        _COSTS.reset(token)


def meta_result(name: str, outputs, *, flops: float, nbytes: float):
    """A wrapper's answer on meta tensors: ``outputs`` (empty meta tensors of
    the kernel's shapes and dtypes) as they are, the call's cost recorded
    when :func:`record_costs` is open."""
    log = _COSTS.get()
    if log is not None:
        log.append(KernelCost(name, float(flops), float(nbytes)))
    return outputs


def meta_empty(*shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A hand kernel writes into ``torch.empty`` outputs and has no backward:
    its result carries no ``grad_fn``. So a launch on inputs that require
    grad while grad is enabled raises, instead of cutting the graph
    silently (the CPU twins, plain PyTorch, differentiate)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.inference_mode() or torch.no_grad(), or on tensors that do not "
            "require grad")


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
    (0-d tensors are read back to the host once; a Python number takes no
    tensor, which costs a warm call several microseconds a parameter). A
    meta tensor holds no value: it reads as NaN, which no kernel ever
    receives, since a wrapper on meta tensors launches nothing."""
    if isinstance(x, (float, int)):
        return struct.unpack("f", struct.pack("f", x))[0]
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type == "meta":
        return float("nan")
    return float(x.item())
