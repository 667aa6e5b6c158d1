"""The native loader: JPEG frames and ``.flo`` flows to arrays, in C++ and
on the GPU.

The port's counterpart of ``ammcnet_aaai2021_tpu/data/native.py``, with
its API:

    decode_video(paths, size, n_threads=8, device="cpu") -> (T, h, w, 3) u8 RGB
        (on a CUDA device a (T, h, w, 1 or 3) uint8 tensor there)
    load_flow_video(paths, size, reproduce_bug=True, n_threads=8)
        -> (T, h, w, 2) float32, normalized

``device`` says where JPEG decoding runs:

* ``"cpu"``: ``csrc/ammc_loader.cpp`` (the port's copy of the JAX
  package's loader) built with libjpeg: a std::thread pool decodes and
  resizes on the host.
* a CUDA device: ``csrc/jpeg_decode.cu``: nvJPEG decodes on the card, the
  kernel behind :func:`ycc_to_rgb_u8` turns a colour frame's planes into
  RGB as libjpeg does, and the kernel behind :func:`resize_bilinear_u8`
  resizes into a tensor on the card, which the scorer reads there: one
  channel for a grayscale video (the value the host route puts on all
  three), else RGB.  This is the route of a machine whose host has no
  libjpeg (the H100 machine has none; the CUDA toolkit ships nvJPEG).

Both resize with cv2 INTER_LINEAR's half-pixel map in float arithmetic: the
host route is within 1 LSB of cv2's decode + resize; the GPU route adds
nvJPEG's IDCT rounding.  Flows always take the host library, whose
``.flo`` half needs no codec.

The host library is built with ``g++`` at first use into ``build/native/``
(which git ignores), in two forms (with and without libjpeg), each keyed by
a hash of the source and the flags; the GPU one by
:mod:`ammcnet_aaai2021_torch.ops.cuda_build`.  Both are loaded with
:mod:`ctypes`.  There is no fallback: a build or load that fails raises
``RuntimeError`` with the compiler's output, and so does a file that fails
to open or decode.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ammc_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
# the JAX package's build flags, so the two host libraries agree bitwise
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
# the library's two forms: (defines, libraries); JPEG decoding needs libjpeg,
# the .flo half nothing
FORMS = {"jpeg": (("-DAMMC_WITH_LIBJPEG",), ("-ljpeg", "-lpthread")),
         "flo": ((), ("-lpthread",))}
JPEG_EXTS = (".jpg", ".jpeg")
# the C functions' error codes (csrc/ammc_loader.cpp, csrc/jpeg_decode.cu)
ERRORS = {2: "a file does not open", 3: "a file is not a decodable JPEG",
          4: "a file is not a .flo file (bad magic)",
          5: "a .flo file is truncated", 6: "a CUDA error",
          7: "an nvJPEG error", 8: "a JPEG has other than 1 or 3 components",
          9: "a colour JPEG is subsampled other than 4:4:4, 4:2:2 or 4:2:0"}
# libjpeg's YCbCr -> RGB constants (jdcolor.c, 16 fraction bits):
# FIX(1.40200), FIX(1.77200), FIX(0.71414), FIX(0.34414), ONE_HALF
CR_R, CB_B, CR_G, CB_G, ONE_HALF = 91881, 116130, 46802, 22554, 32768

_libs: Dict[str, ctypes.CDLL] = {}
_decoders: Dict[int, ctypes.c_void_p] = {}
_lock = threading.Lock()


def library_path(form: str) -> Path:
    defines, libs = FORMS[form]
    flags = " ".join((CXX, *CXX_FLAGS, *defines, *libs))
    key = hashlib.sha256(SOURCE.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libammc_loader-{form}-{key}.so"


def _build(form: str, out: Path) -> None:
    defines, libs = FORMS[form]
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, *defines, str(SOURCE), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the native loader ({form}) failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building the native loader ({form}) failed: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _library(form: str) -> ctypes.CDLL:
    """The host library in ``form`` ("jpeg" or "flo"), built first if
    needed, its C functions typed."""
    with _lock:
        if form not in _libs:
            path = library_path(form)
            if not path.exists():
                _build(form, path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the native loader {path} "
                                   f"failed: {e}") from e
            paths, c_int = ctypes.POINTER(ctypes.c_char_p), ctypes.c_int
            if form == "jpeg":
                lib.ammc_decode_video.argtypes = [
                    paths, c_int, c_int, c_int, c_int, ctypes.c_void_p]
                lib.ammc_decode_video.restype = c_int
            lib.ammc_load_flow_video.argtypes = [
                paths, c_int, c_int, c_int, c_int, c_int, ctypes.c_void_p]
            lib.ammc_load_flow_video.restype = c_int
            _libs[form] = lib
        return _libs[form]


@functools.cache
def _gpu_library() -> ctypes.CDLL:
    """The nvJPEG decode + resize library (``csrc/jpeg_decode.cu``), its C
    functions typed (once per process)."""
    lib = cuda_build.load("jpeg_decode")
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ammc_jpeg_decoder_create.argtypes = [c_int, ctypes.POINTER(ptr)]
    lib.ammc_jpeg_decoder_create.restype = c_int
    lib.ammc_gpu_decode_video.argtypes = [
        ptr, ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int, ptr, ptr,
        ctypes.POINTER(c_int), ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.ammc_gpu_decode_video.restype = c_int
    lib.ammc_ycc_to_rgb.argtypes = [ptr, ptr, ptr, c_int, c_int, c_int,
                                    c_int, c_int, c_int, ptr, ptr]
    lib.ammc_ycc_to_rgb.restype = c_int
    lib.ammc_resize_bilinear_u8.argtypes = [
        ptr, c_int, c_int, c_int, c_int, ptr, c_int, c_int, ptr]
    lib.ammc_resize_bilinear_u8.restype = c_int
    lib.ammc_cuda_error_string.argtypes = [c_int]
    lib.ammc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _decoder(device: int) -> ctypes.c_void_p:
    """The process's nvJPEG decoder on ``device`` (its own stream)."""
    lib = _gpu_library()
    with _lock:
        if device not in _decoders:
            handle = ctypes.c_void_p()
            _raise_on(lib.ammc_jpeg_decoder_create(device,
                                                   ctypes.byref(handle)),
                      "creating the nvJPEG decoder", [])
            _decoders[device] = handle
        return _decoders[device]


def _raise_on(rc: int, what: str, paths: Sequence[str]) -> None:
    if rc != 0:
        where = f" ({len(paths)} files from {paths[0]})" if paths else ""
        raise RuntimeError(f"{what} failed with code {rc}: "
                           f"{ERRORS.get(rc, 'unknown')}{where}")


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def _check_kind(paths: Sequence[str], exts: Tuple[str, ...], kind: str):
    bad = [p for p in paths if not p.lower().endswith(exts)]
    if bad:
        raise ValueError(f"the native loader reads {kind} files only; got "
                         f"{bad[0]}")


def decode_video(paths: Sequence[str], size: Tuple[int, int],
                 n_threads: int = 8, device="cpu"):
    """JPEG files -> frames resized to ``size``, decoded on ``device``.

    "cpu": the host library's ``n_threads`` threads; a (T, h, w, 3) uint8
    RGB numpy array.  A CUDA device: nvJPEG, the colour and the resize
    kernels on the decoder's stream, one frame after another (``n_threads``
    is not used); a (T, h, w, C) uint8 tensor on that device, C = 1 when
    every frame is a grayscale JPEG (the value the host route puts on all
    three channels) else 3, RGB; the current stream waits for the decode,
    which waits for the work queued on it before the call.  Raises on a
    file that is not a JPEG, does not open or does not decode."""
    _check_kind(paths, JPEG_EXTS, "JPEG")
    device = torch.device(device)
    h, w = size
    if device.type == "cpu":
        out = np.empty((len(paths), h, w, 3), np.uint8)
        if paths:
            rc = _library("jpeg").ammc_decode_video(
                _paths_array(paths), len(paths), h, w, n_threads,
                out.ctypes.data)
            _raise_on(rc, "native decode_video", paths)
        return out
    if device.type != "cuda":
        raise ValueError(f"no JPEG decoder for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"decode_video on {device}: no CUDA device "
                           "is visible")
    device = torch.device("cuda", device.index if device.index is not None
                          else torch.cuda.current_device())
    # room for RGB; a grayscale video takes the first third
    out = torch.empty((len(paths), h, w, 3), dtype=torch.uint8, device=device)
    if not paths:
        return out
    lib = _gpu_library()
    channels, resizes, conversions = (ctypes.c_int(0) for _ in range(3))
    rc = lib.ammc_gpu_decode_video(
        _decoder(device.index), _paths_array(paths), len(paths), h, w,
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        ctypes.byref(channels), ctypes.byref(resizes),
        ctypes.byref(conversions))
    resize_bilinear_u8.launches += resizes.value
    ycc_to_rgb_u8.launches += conversions.value
    _raise_on(rc, "GPU decode_video", paths)
    c = channels.value
    return out.view(-1)[:len(paths) * h * w * c].view(len(paths), h, w, c)


def load_flow_video(paths: Sequence[str], size: Tuple[int, int],
                    reproduce_bug: bool = True,
                    n_threads: int = 8) -> np.ndarray:
    """``.flo`` files -> (T, h, w, 2) float32, resized and normalized as
    ``data/datasets.py:load_flow`` does (``reproduce_bug``: the reference's
    channel overwrite), on the host library's ``n_threads`` threads."""
    _check_kind(paths, (".flo",), ".flo")
    h, w = size
    out = np.empty((len(paths), h, w, 2), np.float32)
    if paths:
        rc = _library("flo").ammc_load_flow_video(
            _paths_array(paths), len(paths), h, w, int(reproduce_bug),
            n_threads, out.ctypes.data)
        _raise_on(rc, "native load_flow_video", paths)
    return out


def _axis_map(src_n: int, dst_n: int, device) -> Tuple[torch.Tensor, ...]:
    """One axis of the half-pixel map in float32, as the kernel computes
    it: both taps clamped to the edge, and the second tap's weight.  Built
    on ``device`` from Python scalars (a CUDA graph may capture it)."""
    scale = float(np.float32(src_n) / np.float32(dst_n))  # a float32 quotient
    fx = (torch.arange(dst_n, dtype=torch.float32, device=device) + 0.5) \
        * scale - 0.5
    x0 = torch.floor(fx)
    w = fx - x0
    i0 = x0.clamp(0, src_n - 1).long()
    i1 = (x0 + 1).clamp(0, src_n - 1).long()
    return i0, i1, w


def resize_bilinear_u8_ref(src: torch.Tensor, size: Tuple[int, int]
                           ) -> torch.Tensor:
    """Plain PyTorch version of the resize kernel: (n, sh, sw, c) u8 with c
    1 or 3 -> (n, h, w, c) u8, each product and sum rounded to float32 as
    the kernel's are."""
    y0, y1, wy = _axis_map(src.shape[1], size[0], src.device)
    x0, x1, wx = _axis_map(src.shape[2], size[1], src.device)
    f = src.float()
    wx = wx[None, None, :, None]
    wy = wy[None, :, None, None]
    rows = [f[:, y] for y in (y0, y1)]
    h0, h1 = ((1 - wx) * r[:, :, x0] + wx * r[:, :, x1] for r in rows)
    return ((1 - wy) * h0 + wy * h1 + 0.5).to(torch.uint8)


def resize_bilinear_u8(src: torch.Tensor, size: Tuple[int, int]
                       ) -> torch.Tensor:
    """The GPU route's resize: (n, sh, sw, c) u8, c 1 or 3, contiguous ->
    (n, h, w, c) u8.  A CUDA tensor launches the kernel of
    ``csrc/jpeg_decode.cu`` on the current stream (counted in
    ``resize_bilinear_u8.launches``, as are the GPU decode's launches); a
    CPU tensor returns the plain version's result."""
    if src.ndim != 4 or src.dtype != torch.uint8 or src.shape[3] not in (1, 3):
        raise ValueError(f"want (n, h, w, 1|3) uint8, got {tuple(src.shape)} "
                         f"{src.dtype}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if src.device.type == "cpu":
        return resize_bilinear_u8_ref(src, size)
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    n, sh, sw, c = src.shape
    out = torch.empty((n, *size, c), dtype=torch.uint8, device=src.device)
    if n == 0:
        return out
    lib = _gpu_library()
    with torch.cuda.device(src.device):
        err = lib.ammc_resize_bilinear_u8(
            src.data_ptr(), n, sh, sw, c, out.data_ptr(), size[0], size[1],
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize kernel launch failed: CUDA error {err} "
                           f"({lib.ammc_cuda_error_string(err).decode()})")
    resize_bilinear_u8.launches += 1
    return out


resize_bilinear_u8.launches = 0


def _chroma_factors(y: torch.Tensor, cb: torch.Tensor) -> Tuple[int, int]:
    """(hs, vs) of planes y (h, w) and cb (ch, cw): 4:4:4, 4:2:2 or 4:2:0."""
    (h, w), (ch, cw) = y.shape, cb.shape
    hs, vs = (1 if cw == w else 2), (1 if ch == h else 2)
    if ((hs, vs) not in ((1, 1), (2, 1), (2, 2)) or cw != -(-w // hs)
            or ch != -(-h // vs)):
        raise ValueError(f"chroma {tuple(cb.shape)} is not 4:4:4, 4:2:2 or "
                         f"4:2:0 of luma {tuple(y.shape)}")
    return hs, vs


def _upsample_ref(c: torch.Tensor, h: int, w: int, hs: int, vs: int
                  ) -> torch.Tensor:
    """libjpeg's fancy upsampling of one chroma plane to (h, w), int32
    (jdsample.c h2v2_fancy_upsample / h2v1_fancy_upsample; edge samples
    stand in for missing neighbours)."""
    c = c.int()
    if hs == 1:
        return c
    ch, cw = c.shape
    x = torch.arange(w, device=c.device)
    col, odd = x // 2, x % 2 == 1
    nb = torch.where(odd, (col + 1).clamp(max=cw - 1), (col - 1).clamp(min=0))
    if vs == 1:
        return (3 * c[:, col] + c[:, nb] + torch.where(odd, 2, 1)) >> 2
    y = torch.arange(h, device=c.device)
    r = y // 2
    far = torch.where(y % 2 == 1, (r + 1).clamp(max=ch - 1),
                      (r - 1).clamp(min=0))
    sums = 3 * c[r] + c[far]  # (h, cw): the two rows' triangle
    return (3 * sums[:, col] + sums[:, nb] + torch.where(odd, 7, 8)) >> 4


def ycc_to_rgb_u8_ref(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of the colour kernel: a JPEG's Y (h, w) and
    Cb, Cr (ch, cw) u8 planes -> (h, w, 3) u8 RGB, libjpeg's upsampling and
    fixed-point conversion (bitwise libjpeg's RGB decode on its planes)."""
    hs, vs = _chroma_factors(y, cb)
    h, w = y.shape
    b = _upsample_ref(cb, h, w, hs, vs) - 128
    r = _upsample_ref(cr, h, w, hs, vs) - 128
    luma = y.int()
    rgb = torch.stack([
        luma + ((CR_R * r + ONE_HALF) >> 16),
        luma + ((-CB_G * b + ONE_HALF - CR_G * r) >> 16),
        luma + ((CB_B * b + ONE_HALF) >> 16)], dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


def ycc_to_rgb_u8(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
                  ) -> torch.Tensor:
    """The GPU route's colour conversion: contiguous u8 planes Y (h, w),
    Cb and Cr (ch, cw) of a 4:4:4, 4:2:2 or 4:2:0 JPEG -> (h, w, 3) u8
    RGB.  CUDA tensors launch the kernel of ``csrc/jpeg_decode.cu`` on the
    current stream (counted in ``ycc_to_rgb_u8.launches``, as are the GPU
    decode's launches); CPU tensors return the plain version's result."""
    planes = (y, cb, cr)
    if (any(p.ndim != 2 or p.dtype != torch.uint8 or not p.is_contiguous()
            for p in planes) or cb.shape != cr.shape
            or len({p.device for p in planes}) != 1):
        raise ValueError("want contiguous 2-D uint8 planes on one device, Cb "
                         "and Cr of one shape")
    hs, vs = _chroma_factors(y, cb)
    if y.device.type == "cpu":
        return ycc_to_rgb_u8_ref(y, cb, cr)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    (h, w), (ch, cw) = y.shape, cb.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    lib = _gpu_library()
    with torch.cuda.device(y.device):
        err = lib.ammc_ycc_to_rgb(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), h, w, ch, cw, hs, vs,
            out.data_ptr(), torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"colour kernel launch failed: CUDA error {err} "
                           f"({lib.ammc_cuda_error_string(err).decode()})")
    ycc_to_rgb_u8.launches += 1
    return out


ycc_to_rgb_u8.launches = 0
