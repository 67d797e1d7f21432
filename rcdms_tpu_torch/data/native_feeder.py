"""ctypes binding of the native story feeder (`native/story_feeder.cpp`),
the port's counterpart of `rcdms_tpu/data/native_feeder.py`: a C++ thread
pool packs a batch's pixel tensors (the protocol's bilinear pixel resize
and bicubic CLIP resize, each bit for bit Pillow's, and the masks) while
Python tokenizes.

The library is compiled from the repository's source with g++ and the
flags of `native/Makefile` at first use, never at import, into
`build/rcdms_tpu_torch/` at the repository root:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -pthread -shared \
        -o build/rcdms_tpu_torch/libstory_feeder_<digest>.so \
        native/story_feeder.cpp

Its name carries a digest of the source, the flags, the compiler and the
host CPU (-march=native), so an edited source is rebuilt, and so is a
library copied from another host. A build or load that fails raises with the
compiler's message: a feeder that was asked for never falls back to the
numpy protocol."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "story_feeder.cpp"
BUILD_DIR = REPO / "build" / "rcdms_tpu_torch"
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-pthread", "-shared")

_libs: Dict[str, ctypes.CDLL] = {}


class FeederBuildError(RuntimeError):
    """The feeder's source did not compile or its library did not load."""


def _compiler_id() -> str:
    try:
        return subprocess.run([CXX, "--version"], capture_output=True,
                              text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise FeederBuildError(f"no C++ compiler {CXX!r}: {e}") from e


def _host_cpu() -> str:
    """The host CPU's model and flags: -march=native builds for them, so a
    library built on another host is not reused."""
    try:
        with open("/proc/cpuinfo") as fh:
            return "".join(line for line in fh
                           if line.startswith(("model name", "flags")))[:8192]
    except OSError:
        return ""


def build_library(source: Optional[Path] = None,
                  build_dir: Optional[Path] = None) -> Path:
    """Compile `source` (default `SOURCE`) into `build_dir` (default
    `BUILD_DIR`) unless a library of the same digest is there; returns the
    library's path. Raises FeederBuildError with the compiler's output if
    the build fails."""
    source = Path(source or SOURCE)
    digest = hashlib.sha256(source.read_bytes() + " ".join(
        (CXX,) + CXXFLAGS).encode() + _compiler_id().encode()
        + _host_cpu().encode()).hexdigest()
    lib = Path(build_dir or BUILD_DIR) / f"lib{source.stem}_{digest[:16]}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile into a private file, then rename: processes that build at
    # once never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXXFLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise FeederBuildError(
                f"{CXX} failed to build {source} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_library(path: Optional[str] = None) -> ctypes.CDLL:
    """The feeder library at `path`, else the one built from `SOURCE`
    (built now if needed); memoized by path. Raises FeederBuildError."""
    path = str(path or build_library())
    lib = _libs.get(path)
    if lib is not None:
        return lib
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise FeederBuildError(f"cannot load {path}: {e}") from e
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.feeder_create.restype = ctypes.c_void_p
    lib.feeder_create.argtypes = [ctypes.c_int]
    lib.feeder_submit_story.restype = None
    lib.feeder_submit_story.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p, f32p, f32p, f32p]
    lib.feeder_wait.restype = None
    lib.feeder_wait.argtypes = [ctypes.c_void_p]
    lib.feeder_destroy.restype = None
    lib.feeder_destroy.argtypes = [ctypes.c_void_p]
    lib.pack_story.restype = None
    lib.pack_story.argtypes = lib.feeder_submit_story.argtypes[1:]
    for name in ("resize_bicubic", "resize_bilinear"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [u8p] + [ctypes.c_int] * 4 + [u8p]
    _libs[path] = lib
    return lib


def available() -> bool:
    """Whether the feeder library builds (or is built) and loads here."""
    try:
        load_library()
    except (FeederBuildError, OSError):
        return False
    return True


class NativeFeeder:
    """Thread-pooled story packer:

        feeder = NativeFeeder(num_threads=4)
        out = feeder.pack_batch(frame_arrays, known_lengths, size, csize)

    The outputs come from a ring of `buffer_depth` buffer sets, faulted in
    once (fresh pages a batch cost more than the pixel work). A returned
    batch is overwritten `buffer_depth` `pack_batch` calls later, so a
    consumer copies it (to the card) before then; the arrays are
    read-only views, so a write into one fails instead of changing a
    later batch. A consumer that prefetches or holds more than
    `buffer_depth - 1` batches raises `buffer_depth`
    (`StoryH5Dataset.feeder_buffer_depth`) or passes `copy=True`."""

    def __init__(self, num_threads: int = 4, buffer_depth: int = 2):
        self._lib = load_library()
        self._pool = self._lib.feeder_create(num_threads)
        self._depth = max(1, buffer_depth)
        self._rings: Dict = {}
        self._ring_idx: Dict = {}

    def close(self):
        if self._pool:
            self._lib.feeder_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _ring(self, b: int, f: int, size: int, csize: int) -> list:
        key = (b, f, size, csize)
        ring = self._rings.get(key)
        if ring is None:
            m = size // 8
            shapes = {
                "target": (b, f, size, size, 3),
                "source": (b, f, size, size, 3),
                "reference_clip": (b, f, csize, csize, 3),
                "source_clip": (b, f, csize, csize, 3),
                "mask_clip": (b, f, csize, csize, 3),
                "mask_label": (b, f, m, m, 1),
            }
            ring = []
            for _ in range(self._depth):
                bufs = {k: np.empty(s, np.float32)
                        for k, s in shapes.items()}
                for a in bufs.values():
                    a.fill(0)  # fault the pages in once
                ring.append(bufs)
            self._rings[key] = ring
            self._ring_idx[key] = 0
        idx = self._ring_idx[key]
        self._ring_idx[key] = (idx + 1) % self._depth
        return ring[idx]

    def pack_batch(self, stories: Sequence[np.ndarray],
                   known_lengths: Sequence[int], size: int,
                   csize: int, copy: bool = False) -> Dict[str, np.ndarray]:
        """stories: (f, h, w, 3) uint8 arrays of one shape. Returns the
        batched pixel tensors of `data/protocol.py` (leading batch dim) and
        `frame_known`, as read-only views into the ring (valid for
        `buffer_depth - 1` further calls), or owned copies with
        `copy=True`."""
        b = len(stories)
        f, h, w, _ = stories[0].shape
        out = dict(self._ring(b, f, size, csize))
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        holds = []  # the contiguous inputs live until feeder_wait returns
        for i, story in enumerate(stories):
            story = np.ascontiguousarray(story, np.uint8)
            if story.shape != (f, h, w, 3):
                raise ValueError(f"story {i} is {story.shape}, story 0 "
                                 f"{(f, h, w, 3)}")
            if not 0 <= int(known_lengths[i]) <= f:
                raise ValueError(f"story {i}: known length "
                                 f"{known_lengths[i]} outside [0, {f}]")
            holds.append(story)
            self._lib.feeder_submit_story(
                self._pool, story.ctypes.data_as(u8p), f, h, w, size, csize,
                int(known_lengths[i]),
                *(out[k][i].ctypes.data_as(f32p) for k in (
                    "target", "source", "reference_clip", "source_clip",
                    "mask_clip", "mask_label")))
        self._lib.feeder_wait(self._pool)
        if copy:
            out = {k: v.copy() for k, v in out.items()}
        else:
            views = {}
            for k, v in out.items():
                views[k] = v.view()
                views[k].flags.writeable = False
            out = views
        out["frame_known"] = (np.arange(f)[None, :]
                              < np.asarray(known_lengths)[:, None])
        return out
