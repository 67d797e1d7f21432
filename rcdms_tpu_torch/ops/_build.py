"""Build the hand-written CUDA kernels in ``rcdms_tpu_torch/csrc`` and load
them with ctypes.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu  # each
    nvcc -shared -o librcdms_kernels_<hash>.so *.o

The library lands in ``build/rcdms_tpu_torch/`` at the repository root; its
name carries a hash of the sources and flags, so an edited kernel is rebuilt
and an unchanged one is reused. The build runs at first use, never at
import. Each C entry point returns ``cudaGetLastError()`` after its launch;
`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from rcdms_tpu_torch.ops._grad import traced

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rcdms_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # dtype, q, k, v, o, B, H, Sq, Skv, dh, scale, dp, nv, bn, bq, stages,
    # cluster, row_sum, smem, stream
    "rcdms_attention_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                            _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, q, k, v, o, b, f, n, c, heads, scale, tokens, group, split,
    # smem, grid, stream
    "rcdms_frame_attention_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _I, _I, _I, _P],
    # geglu, x, w1, b1, w2, b2, y, rows, c, inner, stream (fp32)
    "rcdms_ff_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # mode, bn, smem, x, w, bias, y, M, N, K, stream (bf16)
    "rcdms_ff_gemm": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    # dtype, mt, smem, shifts, x, w9, bias, mask, out, xt, B, C, Cout, T,
    # wp, stream
    "rcdms_cm_conv_fwd": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P],
    # dtype, x, mean, mean2, B, N, C, stream
    "rcdms_gn_moments": [_I, _P, _P, _P, _I, _I, _I, _P],
    # dtype, silu, x, scale, bias, y, B, N, C, groups, eps, slab_groups,
    # cluster, rows, threads, smem, stream
    "rcdms_group_norm_act": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                             _I, _I, _I, _I, _P],
    # dtype, silu, x, scale, bias, y, B, N, C, groups, eps, stream
    "rcdms_group_norm_act_slab": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                  _P],
    # cm, norm, split, dscore, q, k, v, o, B, Sq, Skv, W, dk, scale, dp,
    # nv, bn, stages, smem, stream
    "rcdms_smallk_attention": [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _F, _I, _I, _I, _I, _I, _P],
    # cm, kp, stages, smem, q, k, out, B, Sq, Skv, dk, stream
    "rcdms_attn_scores": [_I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # vlayout, n, stages, smem, seeds, p, v, out, B, Sq, Skv, blk, dh,
    # stream
    "rcdms_attn_pv": [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _P],
    # op, cells_per_block, rows, stages, smem, seeds, p, out, B, cells,
    # Skv, blk, scale, stream
    "rcdms_attn_softmax": [_I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                           _F, _P],
}


class Built:
    """The loaded kernel library and what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds  # 0.0 when an earlier build was reused
        self.log = log          # nvcc's output (ptxas register/smem report),
                                # kept beside the library for a reuse


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the rcdms_tpu_torch kernels")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, target: Path) -> str:
    """Compile every source in its own nvcc process, all at once, link the
    objects into `target`, and return nvcc's output."""
    sources = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [Path(tmp_dir) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = Path(tmp_dir) / target.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, target)
    return log


@functools.cache
def library() -> Built:
    """Build (if needed) and load the kernel library; one per process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"librcdms_kernels_{_digest()}.so"
    log_path = target.with_suffix(".log")
    seconds = 0.0
    if not target.exists():
        t0 = time.perf_counter()
        log = _compile(_nvcc(), target)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
    else:
        log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Built(lib, target, seconds, log)


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} failed with CUDA error {code}")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def cuda_operands(name: str, *tensors: torch.Tensor) -> int:
    """Check that a kernel's operands are contiguous float32 or bfloat16
    tensors on one CUDA device, all of one dtype; return the dtype code the
    C entry points take. Raises on anything else, and first where grad mode
    is on and an operand requires grad: the kernel's output would carry no
    autograd graph, so its gradients would be lost without a word (the
    story ops reach their kernels through a `torch.autograd.Function`,
    `ops/_grad.py`, whose forward runs with grad mode off)."""
    if traced(*tensors):
        raise RuntimeError(f"{name}: a raw kernel launch on operands that "
                           f"require grad would drop their gradients; "
                           f"call the op, or launch under torch.no_grad()")
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: operands must share one CUDA device, "
                             f"got {t.device} and {first.device}")
        if t.dtype != first.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: operands must all be float32 or "
                            f"bfloat16, got {t.dtype} and {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return _DTYPE_CODES[first.dtype]


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the pointer ctypes takes."""
    return torch.cuda.current_stream(t.device).cuda_stream
