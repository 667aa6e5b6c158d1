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
* a CUDA device: ``csrc/jpeg_decode.cu``, libjpeg's decode rebuilt: the
  host pool runs the port's own Huffman decode (``csrc/jpeg_huffman.cpp``,
  no libjpeg) to quantized DCT coefficients, and the card dequantizes and
  runs libjpeg's accurate integer IDCT (the kernel behind
  :func:`idct_islow_u8`), turns a colour frame's planes into RGB as libjpeg
  does (:func:`ycc_to_rgb_u8`) and resizes (:func:`resize_bilinear_u8`)
  into a tensor on the card, which the scorer reads there: one channel for
  a grayscale video (the value the host route puts on all three), else
  RGB.  This is the route of a machine whose host has no libjpeg (the H100
  machine has none).

Both routes give the same bytes: libjpeg's decode (islow IDCT, fancy
upsampling, its YCbCr tables), then cv2 INTER_LINEAR's half-pixel map in
float arithmetic, each product and sum rounded (no fused multiply-add),
within 1 LSB of cv2's decode + resize.  The GPU route
takes baseline and extended sequential Huffman JPEGs with 8-bit samples;
a progressive, lossless, hierarchical or arithmetic-coded frame, another
sample precision, other than 1 or 3 components, a colour frame that is
not YCbCr or is subsampled other than 4:4:4, 4:2:2 or 4:2:0 each raise
with its own message (:data:`ERRORS`).  Flows always take the host
library, whose ``.flo`` half needs no codec.

The host library is built with ``g++`` at first use into ``build/native/``
(which git ignores), in three forms (with libjpeg; without, the ``.flo``
half alone; and the coefficient decode alone, :func:`decode_coefs`), each
keyed by a hash of the source and the flags; the GPU one by
:mod:`ammcnet_aaai2021_torch.ops.cuda_build`.  All are loaded with
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
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_build
from .datasets import ClipLoader

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
# the JAX package's build flags, and no contraction of a product and a sum
# into one fused multiply-add: with -march=native g++ fuses some of the
# resize's products into FMAs, on a CPU that has them, and which ones
# depends on its code generation, so the JAX package's host library is 1 LSB
# off the written float arithmetic on some values.  Without
# contraction the host route is that arithmetic on every machine, bitwise
# what the GPU route's resize kernel and the plain versions compute.
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")
# the library's three forms: (source, defines, libraries); JPEG decoding
# needs libjpeg, the .flo half and the coefficient decode nothing
FORMS = {"jpeg": ("ammc_loader.cpp", ("-DAMMC_WITH_LIBJPEG",),
                  ("-ljpeg", "-lpthread")),
         "flo": ("ammc_loader.cpp", (), ("-lpthread",)),
         "coef": ("jpeg_huffman.cpp", (), ("-lpthread",))}
JPEG_EXTS = (".jpg", ".jpeg")
# the C functions' error codes (csrc/ammc_loader.cpp, csrc/jpeg_huffman.cpp,
# csrc/jpeg_decode.cu)
ERRORS = {2: "a file does not open", 3: "a file is not a decodable JPEG",
          4: "a file is not a .flo file (bad magic)",
          5: "a .flo file is truncated", 6: "a CUDA error",
          8: "a JPEG has other than 1 or 3 components",
          9: "a colour JPEG is subsampled other than 4:4:4, 4:2:2 or 4:2:0",
          10: "a JPEG is progressive (SOF2), which the GPU route does not "
              "decode",
          11: "a JPEG is lossless or hierarchical",
          12: "a JPEG is arithmetic-coded",
          13: "a JPEG has other than 8-bit samples",
          14: "a colour JPEG is coded other than as YCbCr"}
# csrc/jpeg_huffman.cpp kInfoInts: width, height, components, then per
# component h_samp, v_samp, width, height, blocks_w, blocks_h
INFO_INTS = 3 + 6 * 3
# libjpeg's islow IDCT (jidctint.c): CONST_BITS, PASS1_BITS and its FIX()
# constants
CONST_BITS, PASS1_BITS = 13, 2
(FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865,
 FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065,
 FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026) = (
    2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995,
    25172)
# libjpeg's YCbCr -> RGB constants (jdcolor.c, 16 fraction bits):
# FIX(1.40200), FIX(1.77200), FIX(0.71414), FIX(0.34414), ONE_HALF
CR_R, CB_B, CR_G, CB_G, ONE_HALF = 91881, 116130, 46802, 22554, 32768

_libs: Dict[str, ctypes.CDLL] = {}
_decoders: Dict[int, ctypes.c_void_p] = {}
_lock = threading.Lock()


def library_path(form: str) -> Path:
    source, defines, libs = FORMS[form]
    flags = " ".join((CXX, *CXX_FLAGS, *defines, *libs))
    key = hashlib.sha256((CSRC / source).read_bytes()
                         + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libammc_loader-{form}-{key}.so"


def _build(form: str, out: Path) -> None:
    source, defines, libs = FORMS[form]
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, *defines, str(CSRC / source), "-o", str(tmp),
           *libs]
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
    """The host library in ``form`` ("jpeg", "flo" or "coef"), built first
    if needed, its C functions typed."""
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
            ptr = ctypes.c_void_p
            if form == "coef":
                lib.ammc_jpeg_info.argtypes = [ctypes.c_char_p, ptr]
                lib.ammc_jpeg_info.restype = c_int
                lib.ammc_jpeg_coefs_video.argtypes = [
                    paths, c_int, c_int, ctypes.POINTER(ptr), ptr]
                lib.ammc_jpeg_coefs_video.restype = c_int
            else:
                if form == "jpeg":
                    lib.ammc_decode_video.argtypes = [
                        paths, c_int, c_int, c_int, c_int, ptr]
                    lib.ammc_decode_video.restype = c_int
                lib.ammc_load_flow_video.argtypes = [
                    paths, c_int, c_int, c_int, c_int, c_int, ptr]
                lib.ammc_load_flow_video.restype = c_int
            _libs[form] = lib
        return _libs[form]


@functools.cache
def _gpu_library() -> ctypes.CDLL:
    """The GPU decode library (``csrc/jpeg_decode.cu``: the Huffman decode
    on the host, the IDCT, colour and resize kernels), its C functions typed
    (once per process)."""
    lib = cuda_build.load("jpeg_decode")
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ammc_jpeg_decoder_create.argtypes = [c_int, ctypes.POINTER(ptr)]
    lib.ammc_jpeg_decoder_create.restype = c_int
    lib.ammc_gpu_decode_video.argtypes = [
        ptr, ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int, c_int, ptr,
        ptr, ctypes.POINTER(c_int), ctypes.POINTER(c_int),
        ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.ammc_gpu_decode_video.restype = c_int
    lib.ammc_idct_islow_u8.argtypes = [ptr, ptr, c_int, c_int, c_int, c_int,
                                       c_int, ptr, ptr]
    lib.ammc_idct_islow_u8.restype = c_int
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
    """The process's GPU decoder on ``device`` (its own stream and
    buffers)."""
    lib = _gpu_library()
    with _lock:
        if device not in _decoders:
            handle = ctypes.c_void_p()
            _raise_on(lib.ammc_jpeg_decoder_create(device,
                                                   ctypes.byref(handle)),
                      "creating the GPU JPEG decoder", [])
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
    RGB numpy array.  A CUDA device: the Huffman decode on ``n_threads``
    host threads, a chunk of frames at a time, then the IDCT, colour and
    resize kernels on the decoder's stream; a (T, h, w, C) uint8 tensor on
    that device, bitwise the host route's, C = 1 when every frame is a
    grayscale JPEG (the value the host route puts on all three channels)
    else 3, RGB; the current stream waits for the decode, which waits for
    the work queued on it before the call.  Raises on a file that is not a
    JPEG, does not open or does not decode, and (GPU route) on a JPEG it
    does not take (:data:`ERRORS`)."""
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
    channels, idcts, resizes, conversions = (ctypes.c_int(0)
                                             for _ in range(4))
    rc = lib.ammc_gpu_decode_video(
        _decoder(device.index), _paths_array(paths), len(paths), h, w,
        n_threads, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
        ctypes.byref(channels), ctypes.byref(idcts), ctypes.byref(resizes),
        ctypes.byref(conversions))
    idct_islow_u8.launches += idcts.value
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



class Component(NamedTuple):
    """One component of a JPEG frame as the coefficient decode gives it."""

    coefs: np.ndarray  # (blocks_h, blocks_w, 64) int16, natural order
    qtable: np.ndarray  # (64,) uint16, natural order
    samp: Tuple[int, int]  # (h_samp, v_samp)
    size: Tuple[int, int]  # its downsampled (height, width)


def decode_coefs(paths: Sequence[str], n_threads: int = 8
                 ) -> List[List[Component]]:
    """JPEG files -> each frame's components, quantized DCT coefficients and
    tables, by the host library's "coef" form (``csrc/jpeg_huffman.cpp``,
    the GPU route's own Huffman decode, no libjpeg) on ``n_threads``
    threads.  Raises on a file it does not take (:data:`ERRORS`)."""
    _check_kind(paths, JPEG_EXTS, "JPEG")
    lib = _library("coef")
    frames, pointers = [], []
    for path in paths:
        info = np.zeros(INFO_INTS, np.int32)
        _raise_on(lib.ammc_jpeg_info(os.fsencode(path), info.ctypes.data),
                  "JPEG coefficient decode", [path])
        comps = []
        for c in range(3):
            hs, vs, cw, ch, bw, bh = (int(v)
                                      for v in info[3 + 6 * c:9 + 6 * c])
            coefs = np.zeros((bh, bw, 64) if c < info[2] else (0,), np.int16)
            pointers.append(coefs.ctypes.data)
            comps.append((coefs, (hs, vs), (ch, cw)))
        frames.append(comps[:int(info[2])])
    qtables = np.zeros((len(paths), 3, 64), np.uint16)
    if paths:
        rc = lib.ammc_jpeg_coefs_video(
            _paths_array(paths), len(paths), n_threads,
            (ctypes.c_void_p * len(pointers))(*pointers), qtables.ctypes.data)
        _raise_on(rc, "JPEG coefficient decode", paths)
    return [[Component(coefs, qtables[i, c], samp, size)
             for c, (coefs, samp, size) in enumerate(comps)]
            for i, comps in enumerate(frames)]


def _range_limit(device) -> torch.Tensor:
    """jdmaster.c's range-limit table as the IDCT reads it: entry
    ``v = x & 1023`` of a descaled sum x (centred on 0) is ``x + 128``
    clamped to [0, 255] for -512 <= x < 512, and wraps beyond."""
    v = torch.arange(1024, device=device)
    out = torch.where(v < 128, v + 128, torch.where(v < 512, 255, 0))
    return torch.where(v >= 896, v - 896, out).to(torch.uint8)


def _idct_1d(d):
    """jidctint.c's butterfly on 8 int32 tensors (the inputs along one
    axis, dequantized in pass 1): the 8 outputs before their DESCALE."""
    z1 = (d[2] + d[6]) * FIX_0_541196100
    tmp2 = z1 + d[6] * -FIX_1_847759065
    tmp3 = z1 + d[2] * FIX_0_765366865
    tmp0 = (d[0] + d[4]) << CONST_BITS
    tmp1 = (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = (tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2,
                                  tmp1 - tmp2)
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0, t1 = t0 * FIX_0_298631336, t1 * FIX_2_053119869
    t2, t3 = t2 * FIX_3_072711026, t3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0,
            tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def idct_islow_u8_ref(coefs: torch.Tensor, qtables: torch.Tensor,
                      size: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the IDCT kernel: (F, blocks_h, blocks_w, 64)
    int16 quantized coefficients in natural order and (F, 64) uint16 tables
    -> (F, h, w) u8 planes, libjpeg's jpeg_idct_islow in int32 ops (the
    table cast to short as libjpeg's SIMD build stores it; products of a
    valid 8-bit JPEG's dequantized coefficients and the constants stay in
    int32), cropped to ``size``.  Without the zero-AC shortcuts, which give
    the same values."""
    f, bh, bw, _ = coefs.shape
    q = qtables.to(torch.int16).to(torch.int32).view(f, 1, 1, 8, 8)
    x = coefs.to(torch.int32).view(f, bh, bw, 8, 8) * q  # DEQUANTIZE
    # pass 1: the columns (axis -2 holds the vertical frequencies)
    cols = _idct_1d(x.unbind(-2))
    ws = torch.stack([_descale(v, CONST_BITS - PASS1_BITS) for v in cols],
                     dim=-2)
    # pass 2: the rows, then the range limit
    rows = _idct_1d(ws.unbind(-1))
    out = torch.stack([_descale(v, CONST_BITS + PASS1_BITS + 3)
                       for v in rows], dim=-1)
    pix = _range_limit(coefs.device)[(out & 1023).long()]
    planes = pix.permute(0, 1, 3, 2, 4).reshape(f, bh * 8, bw * 8)
    return planes[:, :size[0], :size[1]].contiguous()


def idct_islow_u8(coefs: torch.Tensor, qtables: torch.Tensor,
                  size: Tuple[int, int]) -> torch.Tensor:
    """The GPU route's dequantize + IDCT: (F, blocks_h, blocks_w, 64) int16
    and (F, 64) uint16, contiguous -> (F, h, w) u8 planes, ``size`` =
    (h, w) within the blocks.  CUDA tensors launch the kernel of
    ``csrc/jpeg_decode.cu`` on the current stream (counted in
    ``idct_islow_u8.launches``, as are the GPU decode's launches); CPU
    tensors return the plain version's result."""
    if (coefs.ndim != 4 or coefs.shape[3] != 64
            or coefs.dtype != torch.int16 or qtables.dtype != torch.uint16
            or tuple(qtables.shape) != (coefs.shape[0], 64)
            or not coefs.is_contiguous() or not qtables.is_contiguous()
            or coefs.device != qtables.device):
        raise ValueError("want contiguous (F, blocks_h, blocks_w, 64) int16 "
                         "coefficients and (F, 64) uint16 tables on one "
                         "device")
    f, bh, bw, _ = coefs.shape
    h, w = size
    if not (8 * bh - 8 < h <= 8 * bh and 8 * bw - 8 < w <= 8 * bw):
        raise ValueError(f"size {size} is not covered by {bh}x{bw} blocks")
    if coefs.device.type == "cpu":
        return idct_islow_u8_ref(coefs, qtables, size)
    if coefs.device.type != "cuda":
        raise ValueError(f"no kernel for device {coefs.device}")
    out = torch.empty((f, h, w), dtype=torch.uint8, device=coefs.device)
    if f == 0:
        return out
    lib = _gpu_library()
    with torch.cuda.device(coefs.device):
        err = lib.ammc_idct_islow_u8(
            coefs.data_ptr(), qtables.data_ptr(), f, bh, bw, h, w,
            out.data_ptr(),
            torch.cuda.current_stream(coefs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"IDCT kernel launch failed: CUDA error {err} "
                           f"({lib.ammc_cuda_error_string(err).decode()})")
    idct_islow_u8.launches += 1
    return out


idct_islow_u8.launches = 0


def decode_video_ref(paths: Sequence[str], size: Tuple[int, int],
                     n_threads: int = 8) -> torch.Tensor:
    """The GPU route's plain version on the CPU: :func:`decode_coefs`, then
    :func:`idct_islow_u8_ref`, :func:`ycc_to_rgb_u8_ref` and
    :func:`resize_bilinear_u8_ref` -> (T, h, w, 3) u8 RGB, a grayscale
    frame's plane on all three channels, as ``decode_video(device="cpu")``
    gives it."""
    out = []
    for comps in decode_coefs(paths, n_threads):
        planes = [idct_islow_u8_ref(torch.from_numpy(c.coefs)[None],
                                    torch.from_numpy(c.qtable)[None],
                                    c.size)[0] for c in comps]
        rgb = (planes[0][..., None] if len(planes) == 1
               else ycc_to_rgb_u8_ref(*planes))
        out.append(resize_bilinear_u8_ref(rgb[None].contiguous(), size)[0]
                   .expand(*size, 3))
    return torch.stack(out) if out else torch.empty(
        (0, *size, 3), dtype=torch.uint8)


class NativeClipLoader(ClipLoader):
    """A training sampler's clip loader that reads each frame through this
    module, for a machine without cv2: a JPEG frame decoded on ``device``
    (the host library on the CPU, the GPU route on a card) and brought back
    as (h, w, 3) u8 RGB, a ``.flo`` flow by the host library."""

    def __init__(self, data_type: str, image_size: int = 256,
                 reproduce_flow_bug: bool = True, device="cpu"):
        super().__init__(data_type, image_size, reproduce_flow_bug)
        self.device = device

    def _frame(self, path: str) -> np.ndarray:
        if self.data_type == "op":
            return load_flow_video([path], self.size,
                                   self.reproduce_flow_bug)[0]
        frame = decode_video([path], self.size, device=self.device)[0]
        if isinstance(frame, torch.Tensor):
            frame = frame.expand(*self.size, 3).cpu().numpy()
        return frame
