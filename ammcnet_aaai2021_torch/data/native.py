"""The native loader: JPEG frames and ``.flo`` flows to arrays, in C++ and
on the GPU.

The port's counterpart of ``ammcnet_aaai2021_tpu/data/native.py``, with
its API:

    decode_video(paths, size, n_threads=8, device="cpu") -> (T, h, w, 3) u8 RGB
        (on a CUDA device a (T, h, w, 3) uint8 tensor there)
    load_flow_video(paths, size, reproduce_bug=True, n_threads=8)
        -> (T, h, w, 2) float32, normalized

``device`` says where JPEG decoding runs:

* ``"cpu"``: ``csrc/ammc_loader.cpp`` (the port's copy of the JAX
  package's loader) built with libjpeg: a std::thread pool decodes and
  resizes on the host.
* a CUDA device: ``csrc/jpeg_decode.cu``, libjpeg's decode rebuilt: the
  host pool runs the port's own entropy decode (``csrc/jpeg_huffman.cpp``,
  no libjpeg) to quantized DCT coefficients, and the card dequantizes and
  runs libjpeg's accurate integer IDCT (the kernel behind
  :func:`idct_islow_u8`), turns a colour frame's planes into RGB as libjpeg
  does (:func:`ycc_to_rgb_u8`) and resizes (:func:`resize_bilinear_u8`,
  a grayscale frame's one plane to three channels, as the host route
  resizes libjpeg's RGB decode of it) into an RGB tensor on the card,
  which the scorer reads there.  This is the route of a machine whose host
  has no libjpeg (the H100 machine has none).

Both routes give the same bytes: libjpeg's decode (islow IDCT as its x86
SIMD build computes it, fancy upsampling, its YCbCr tables, the block
smoothing of a progressive frame whose scans leave a low coefficient
unrefined, a truncated file decoded as far as libjpeg decodes it), then
cv2 INTER_LINEAR's half-pixel map in float arithmetic with the fused
multiply-adds of the JAX package's ``-O3 -march=native`` build of its
loader (``csrc/ammc_loader.cpp`` says which), within 1 LSB of cv2's
decode + resize.  The GPU route takes
every frame type that libjpeg-turbo 2.1's 8-bit decoder takes: baseline,
extended sequential and progressive JPEGs, Huffman- or arithmetic-coded,
with 8-bit samples; a lossless or hierarchical frame, another sample
precision, other than 1 or 3 components, a colour frame that is not YCbCr
or is subsampled other than 4:4:4, 4:2:2 or 4:2:0 each raise with its own
message (:data:`ERRORS`), as libjpeg refuses most of them.  Flows always
take the host library, whose ``.flo`` half needs no codec.

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
# into one fused multiply-add but the source's own std::fmaf: those write
# out the fusions g++ makes in the JAX package's -march=native build of the
# resize, so the host route computes that build's arithmetic on every
# machine, bitwise what the GPU route's resize kernel and the plain
# versions compute.
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
          10: "a progressive JPEG has a scan whose parameters libjpeg "
              "rejects",
          11: "a JPEG is lossless or hierarchical",
          12: "a JPEG's arithmetic conditioning (DAC) is malformed",
          13: "a JPEG has other than 8-bit samples",
          14: "a colour JPEG is coded other than as YCbCr"}
# csrc/jpeg_huffman.cpp kInfoInts: width, height, components, then per
# component h_samp, v_samp, width, height, blocks_w, blocks_h, then the
# frame's iMCU rows; kLatchInts: whether libjpeg smooths the frame, its last
# good iMCU row, then per component coef_bits[0..9], then per component the
# latch's second row
INFO_INTS = 3 + 6 * 3 + 1
SAVED_COEFS = 10
LATCH_INTS = 2 + 2 * SAVED_COEFS * 3
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
                    paths, c_int, c_int, ctypes.POINTER(ptr), ptr, ptr]
                lib.ammc_jpeg_coefs_video.restype = c_int
                lib.ammc_jpeg_smooth.argtypes = [ptr, ptr, c_int, c_int,
                                                 c_int, c_int, ptr, ptr, ptr,
                                                 c_int]
                lib.ammc_jpeg_smooth.restype = c_int
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
    """The GPU decode library (``csrc/jpeg_decode.cu``: the entropy decode
    on the host, the IDCT, colour and resize kernels), its C functions typed
    (once per process)."""
    lib = cuda_build.load("jpeg_decode")
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ammc_jpeg_decoder_create.argtypes = [c_int, ctypes.POINTER(ptr)]
    lib.ammc_jpeg_decoder_create.restype = c_int
    lib.ammc_gpu_decode_video.argtypes = [
        ptr, ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int, c_int, ptr,
        ptr, ctypes.POINTER(c_int), ctypes.POINTER(c_int),
        ctypes.POINTER(c_int), ctypes.POINTER(ctypes.c_double)]
    lib.ammc_gpu_decode_video.restype = c_int
    lib.ammc_idct_islow_u8.argtypes = [ptr, ptr, c_int, c_int, c_int, c_int,
                                       c_int, ptr, ptr]
    lib.ammc_idct_islow_u8.restype = c_int
    lib.ammc_ycc_to_rgb.argtypes = [ptr, ptr, ptr, c_int, c_int, c_int,
                                    c_int, c_int, c_int, c_int, ptr, ptr]
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
    RGB numpy array.  A CUDA device: the entropy decode (and a progressive
    frame's block smoothing) on ``n_threads`` host threads, a chunk of
    frames at a time, then the IDCT, colour and resize kernels on the
    decoder's stream; a (T, h, w, 3) uint8 RGB tensor on that device,
    bitwise the host route's (a grayscale frame's plane resized to three
    channels, channel 0 with the host's own rounding); the current stream
    waits for the decode, which waits for the work queued on it before the
    call; ``decode_video.host_s`` sums the host's seconds of the GPU route
    (its files' reads, its entropy decode).  Raises on a file that is not a
    JPEG, does not open or does not decode, and (GPU route) on a JPEG that
    libjpeg does not take either (:data:`ERRORS`)."""
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
    out = torch.empty((len(paths), h, w, 3), dtype=torch.uint8, device=device)
    if not paths:
        return out
    lib = _gpu_library()
    idcts, resizes, conversions = (ctypes.c_int(0) for _ in range(3))
    host_s = (ctypes.c_double * 2)()
    rc = lib.ammc_gpu_decode_video(
        _decoder(device.index), _paths_array(paths), len(paths), h, w,
        n_threads, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
        ctypes.byref(idcts), ctypes.byref(resizes), ctypes.byref(conversions),
        host_s)
    idct_islow_u8.launches += idcts.value
    resize_bilinear_u8.launches += resizes.value
    ycc_to_rgb_u8.launches += conversions.value
    decode_video.host_s["read"] += host_s[0]
    decode_video.host_s["entropy"] += host_s[1]
    _raise_on(rc, "GPU decode_video", paths)
    return out


# the GPU route's host seconds, summed over calls: reading the files and
# parsing their headers, and the entropy decode (with block smoothing)
decode_video.host_s = {"read": 0.0, "entropy": 0.0}


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


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """C's ``fmaf`` on float32 tensors: ``a * b + c`` rounded once to
    float32.  The product is exact in float64 (24 + 24 bits), the sum is
    rounded to odd in float64 (TwoSum gives its exact error; a result that
    is not exact and has an even last bit moves one ulp toward the error),
    and a sum rounded to odd with 53 >= 24 + 2 bits rounds to float32 as
    the exact sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _axis_map(src_n: int, dst_n: int, device) -> Tuple[torch.Tensor, ...]:
    """One axis of the half-pixel map in float32, as the kernel computes
    it: both taps clamped to the edge, the second tap's weight, and whether
    the host loader's second row buffer holds a copy of the first (the
    first output row that needs source row ``i1`` has ``i0 == i1``; see
    ``csrc/ammc_loader.cpp:resize_bilinear``).  Built on ``device`` from
    Python scalars (a CUDA graph may capture it)."""
    scale = float(np.float32(src_n) / np.float32(dst_n))  # a float32 quotient
    x = torch.arange(dst_n, dtype=torch.float32, device=device) + 0.5
    fx = _fmaf(x, torch.full_like(x, scale), torch.full_like(x, -0.5))
    x0 = torch.floor(fx)
    w = fx - x0
    i0 = x0.clamp(0, src_n - 1).long()
    i1 = (x0 + 1).clamp(0, src_n - 1).long()
    copied = i0[torch.searchsorted(i1, i1)] == i1  # i1 never decreases
    return i0, i1, w, copied


def _resize_ref(f: torch.Tensor, size: Tuple[int, int], u8: bool
                ) -> torch.Tensor:
    """The host loader's float resize of (n, sh, sw, c) float32 values,
    with its fused multiply-adds: horizontal lerps ``fmaf(1 - w, a, w *
    b)``, except channel 0 of a u8 (RGB) image in the second row buffer
    (not a copy of the first), ``fmaf(w, b, (1 - w) * a)``; vertical
    ``fmaf(1 - wy, h0, wy * h1)``."""
    y0, y1, wy, copied = _axis_map(f.shape[1], size[0], f.device)
    x0, x1, wx, _ = _axis_map(f.shape[2], size[1], f.device)
    wx = wx[None, None, :, None]
    wy = wy[None, :, None, None]

    def lerp(r, second):
        a, b = r[:, :, x0], r[:, :, x1]
        out = _fmaf(1 - wx, a, wx * b)
        if second:
            out[..., 0] = _fmaf(wx, b, (1 - wx) * a)[..., 0]
        return out

    h0 = lerp(f[:, y0], False)
    h1 = lerp(f[:, y1], False)
    if u8:
        h1 = torch.where(copied[None, :, None, None], h1,
                         lerp(f[:, y1], True))
    return _fmaf(1 - wy, h0, wy * h1)


def resize_bilinear_u8_ref(src: torch.Tensor, size: Tuple[int, int]
                           ) -> torch.Tensor:
    """Plain PyTorch version of the resize kernel: (n, sh, sw, c) u8 with c
    1 or 3 -> (n, h, w, 3) u8 (from 1: a grayscale plane resized as the
    host loader resizes libjpeg's RGB decode of it, the same value on three
    channels before the resize), the host loader's arithmetic (its fused
    multiply-adds rounded once, :func:`_fmaf`)."""
    if src.shape[3] == 1:
        src = src.expand(*src.shape[:3], 3)
    if tuple(src.shape[1:3]) == tuple(size):
        return src.clone(memory_format=torch.contiguous_format)
    return (_resize_ref(src.float(), size, True) + 0.5).to(torch.uint8)


def resize_bilinear_f32_ref(src: torch.Tensor, size: Tuple[int, int]
                            ) -> torch.Tensor:
    """The host loader's float resize of ``.flo`` flows (before their
    normalization), in PyTorch: (n, sh, sw, c) float32 -> (n, h, w, c)."""
    if tuple(src.shape[1:3]) == tuple(size):
        return src.clone()
    return _resize_ref(src.float(), size, False)


def resize_bilinear_u8(src: torch.Tensor, size: Tuple[int, int]
                       ) -> torch.Tensor:
    """The GPU route's resize: (n, sh, sw, c) u8, c 1 or 3, contiguous ->
    (n, h, w, 3) u8 (as :func:`resize_bilinear_u8_ref`).  A CUDA tensor
    launches the kernel of ``csrc/jpeg_decode.cu`` on the current stream
    (counted in ``resize_bilinear_u8.launches``, as are the GPU decode's
    launches); a CPU tensor returns the plain version's result."""
    if src.ndim != 4 or src.dtype != torch.uint8 or src.shape[3] not in (1, 3):
        raise ValueError(f"want (n, h, w, 1|3) uint8, got {tuple(src.shape)} "
                         f"{src.dtype}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if src.device.type == "cpu":
        return resize_bilinear_u8_ref(src, size)
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    n, sh, sw, sc = src.shape
    out = torch.empty((n, *size, 3), dtype=torch.uint8, device=src.device)
    if n == 0:
        return out
    lib = _gpu_library()
    with torch.cuda.device(src.device):
        err = lib.ammc_resize_bilinear_u8(
            src.data_ptr(), n, sh, sw, sc, out.data_ptr(), size[0], size[1],
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize kernel launch failed: CUDA error {err} "
                           f"({lib.ammc_cuda_error_string(err).decode()})")
    resize_bilinear_u8.launches += 1
    return out


resize_bilinear_u8.launches = 0


def _chroma_factors(y: torch.Tensor, cb: torch.Tensor) -> Tuple[int, int]:
    """(hs, vs) of planes y (..., h, w) and cb (..., ch, cw): 4:4:4, 4:2:2
    or 4:2:0."""
    (h, w), (ch, cw) = y.shape[-2:], cb.shape[-2:]
    hs, vs = (1 if cw == w else 2), (1 if ch == h else 2)
    if ((hs, vs) not in ((1, 1), (2, 1), (2, 2)) or cw != -(-w // hs)
            or ch != -(-h // vs)):
        raise ValueError(f"chroma {tuple(cb.shape)} is not 4:4:4, 4:2:2 or "
                         f"4:2:0 of luma {tuple(y.shape)}")
    return hs, vs


def _upsample_ref(c: torch.Tensor, h: int, w: int, hs: int, vs: int
                  ) -> torch.Tensor:
    """libjpeg's fancy upsampling of chroma planes (..., ch, cw) to (..., h,
    w), int32 (jdsample.c h2v2_fancy_upsample / h2v1_fancy_upsample; edge
    samples stand in for missing neighbours)."""
    c = c.int()
    if hs == 1:
        return c
    ch, cw = c.shape[-2:]
    x = torch.arange(w, device=c.device)
    col, odd = x // 2, x % 2 == 1
    nb = torch.where(odd, (col + 1).clamp(max=cw - 1), (col - 1).clamp(min=0))
    if vs == 1:
        return (3 * c[..., col] + c[..., nb] + torch.where(odd, 2, 1)) >> 2
    y = torch.arange(h, device=c.device)
    r = y // 2
    far = torch.where(y % 2 == 1, (r + 1).clamp(max=ch - 1),
                      (r - 1).clamp(min=0))
    sums = 3 * c[..., r, :] + c[..., far, :]  # (..., h, cw): the triangle
    return (3 * sums[..., col] + sums[..., nb] + torch.where(odd, 7, 8)) >> 4


def ycc_to_rgb_u8_ref(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of the colour kernel: a JPEG's Y (h, w) and
    Cb, Cr (ch, cw) u8 planes -> (h, w, 3) u8 RGB, or a chunk's, (F, h, w)
    and (F, ch, cw) -> (F, h, w, 3): libjpeg's upsampling and fixed-point
    conversion (bitwise libjpeg's RGB decode on its planes)."""
    hs, vs = _chroma_factors(y, cb)
    h, w = y.shape[-2:]
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
    RGB, or a chunk of frames, (F, h, w) and (F, ch, cw) -> (F, h, w, 3).
    CUDA tensors launch the kernel of ``csrc/jpeg_decode.cu`` once on the
    current stream (counted in ``ycc_to_rgb_u8.launches``, as are the GPU
    decode's launches, one a chunk); CPU tensors return the plain version's
    result."""
    planes = (y, cb, cr)
    if (y.ndim not in (2, 3) or any(
            p.ndim != y.ndim or p.dtype != torch.uint8 or not p.is_contiguous()
            for p in planes) or cb.shape != cr.shape
            or cb.shape[:-2] != y.shape[:-2]
            or len({p.device for p in planes}) != 1):
        raise ValueError("want contiguous 2-D or 3-D uint8 planes on one "
                         "device, Cb and Cr of one shape, as many frames as "
                         "Y")
    hs, vs = _chroma_factors(y, cb)
    if y.device.type == "cpu":
        return ycc_to_rgb_u8_ref(y, cb, cr)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    (h, w), (ch, cw) = y.shape[-2:], cb.shape[-2:]
    frames = y.shape[0] if y.ndim == 3 else 1
    out = torch.empty((*y.shape, 3), dtype=torch.uint8, device=y.device)
    if frames == 0:
        return out
    lib = _gpu_library()
    with torch.cuda.device(y.device):
        err = lib.ammc_ycc_to_rgb(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), frames, h, w, ch, cw,
            hs, vs, out.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream)
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
    # libjpeg's block smoothing at output: whether it smooths the frame,
    # the component's coef_bits[0..9] latch and the latch's second row
    # (coef_bits before the component's last scan), which the iMCU rows past
    # the frame's last good one read (a truncated last scan), and the
    # frame's iMCU rows
    smooth: bool
    coef_bits: np.ndarray  # (10,) int32
    prev_coef_bits: np.ndarray  # (10,) int32
    last_good_imcu: int
    imcu_rows: int


def decode_coefs(paths: Sequence[str], n_threads: int = 8
                 ) -> List[List[Component]]:
    """JPEG files -> each frame's components, quantized DCT coefficients
    (unsmoothed, as libjpeg's ``jpeg_read_coefficients`` gives them), tables
    and smoothing latch, by the host library's "coef" form
    (``csrc/jpeg_huffman.cpp``, the GPU route's own entropy decode, no
    libjpeg) on ``n_threads`` threads.  Raises on a file it does not take
    (:data:`ERRORS`)."""
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
        frames.append((comps[:int(info[2])], int(info[-1])))
    qtables = np.zeros((len(paths), 3, 64), np.uint16)
    latch = np.zeros((len(paths), LATCH_INTS), np.int32)
    if paths:
        rc = lib.ammc_jpeg_coefs_video(
            _paths_array(paths), len(paths), n_threads,
            (ctypes.c_void_p * len(pointers))(*pointers), qtables.ctypes.data,
            latch.ctypes.data)
        _raise_on(rc, "JPEG coefficient decode", paths)
    bits = latch[:, 2:].reshape(len(paths), 2, 3, SAVED_COEFS)
    return [[Component(coefs, qtables[i, c], samp, size, bool(latch[i, 0]),
                       bits[i, 0, c], bits[i, 1, c], int(latch[i, 1]),
                       imcu_rows)
             for c, (coefs, samp, size) in enumerate(comps)]
            for i, (comps, imcu_rows) in enumerate(frames)]


def smooth_coefs(comp: Component) -> np.ndarray:
    """A component's blocks as libjpeg hands them to its IDCT: block-smoothed
    (``csrc/jpeg_huffman.cpp:smooth_component``, the function the GPU route
    runs on its host threads) where ``comp.smooth``, else as decoded."""
    if not comp.smooth:
        return comp.coefs
    out = np.empty_like(comp.coefs)
    bh, bw, _ = comp.coefs.shape
    coefs = np.ascontiguousarray(comp.coefs)
    qtable = np.ascontiguousarray(comp.qtable)
    bits = np.ascontiguousarray(comp.coef_bits, dtype=np.int32)
    prev = np.ascontiguousarray(comp.prev_coef_bits, dtype=np.int32)
    _library("coef").ammc_jpeg_smooth(
        coefs.ctypes.data, out.ctypes.data, bh, bw, comp.samp[1],
        comp.imcu_rows, qtable.ctypes.data, bits.ctypes.data,
        prev.ctypes.data, comp.last_good_imcu)
    return out


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int32 ``x``, sign-extended (a 16-bit lane's
    wrapping add or multiply)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _sample(x: torch.Tensor) -> torch.Tensor:
    """Pass 2's descaled values as samples: saturated to [-128, 127]
    (``packssdw``, ``packsswb``), then + CENTERJSAMPLE."""
    return (x.clamp(-128, 127) + 128).to(torch.uint8)


def _idct_1d(d):
    """The butterfly of libjpeg-turbo's x86 SIMD islow IDCT
    (jidctint-avx2.asm, jidctint-sse2.asm) on 8 int32 tensors of 16-bit
    values (the inputs along one axis): the 8 outputs before their
    DESCALE.  It is jidctint.c's butterfly with its products regrouped as
    ``pmaddwd`` pairs, and the sums in0 + in4, in0 - in4, in1 + in5 and
    in3 + in7 taken in 16-bit lanes, which wrap; every other sum fits in
    int32 for 16-bit inputs."""
    in0, in1, in2, in3, in4, in5, in6, in7 = d
    # even part: tmp3 = z2 (F054 + F076) + z3 F054, tmp2 = z2 F054 + z3
    # (F054 - F184)
    tmp3 = in2 * (FIX_0_541196100 + FIX_0_765366865) + in6 * FIX_0_541196100
    tmp2 = in2 * FIX_0_541196100 + in6 * (FIX_0_541196100 - FIX_1_847759065)
    tmp0 = _wrap16(in0 + in4) << CONST_BITS
    tmp1 = _wrap16(in0 - in4) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = (tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2,
                                  tmp1 - tmp2)
    # odd part: z3 = in7 + in3, z4 = in5 + in1 (16-bit), then z5 folded in
    z3, z4 = _wrap16(in7 + in3), _wrap16(in5 + in1)
    z3, z4 = (z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602,
              z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644))
    t0 = (in7 * (FIX_0_298631336 - FIX_0_899976223) + in1 * -FIX_0_899976223
          + z3)
    t3 = (in7 * -FIX_0_899976223 + in1 * (FIX_1_501321110 - FIX_0_899976223)
          + z4)
    t1 = (in5 * (FIX_2_053119869 - FIX_2_562915447) + in3 * -FIX_2_562915447
          + z4)
    t2 = (in5 * -FIX_2_562915447 + in3 * (FIX_3_072711026 - FIX_2_562915447)
          + z3)
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0,
            tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def idct_islow_u8_ref(coefs: torch.Tensor, qtables: torch.Tensor,
                      size: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the IDCT kernel: (F, blocks_h, blocks_w, 64)
    int16 quantized coefficients in natural order and (F, 64) uint16 tables
    -> (F, h, w) u8 planes, cropped to ``size``: libjpeg-turbo's islow IDCT
    as its x86 SIMD build (jidctint-avx2.asm, which cv2 and the host loader
    run) computes it: dequantized by ``pmullw`` (the low 16 bits of
    coefficient x table, the table as a short), a column pass whose outputs
    are descaled by CONST_BITS - PASS1_BITS and saturated to 16 bits
    (``packssdw``) -- or, when rows 1-7 of the block are all zero, the
    dequantized first row << PASS1_BITS in 16-bit lanes -- and a row pass
    descaled by CONST_BITS + PASS1_BITS + 3 and saturated to samples
    (:func:`_sample`).  For the coefficients of a real 8-bit image this is
    jidctint.c's result; where 16-bit lanes wrap or saturate, or a sum
    passes jidctint.c's range limit (which wraps beyond +-512), it is the
    SIMD build's."""
    f, bh, bw, _ = coefs.shape
    q = qtables.to(torch.int16).to(torch.int32).view(f, 1, 1, 8, 8)
    x = coefs.to(torch.int32).view(f, bh, bw, 8, 8)
    dq = _wrap16(x * q)  # DEQUANTIZE (pmullw)
    # pass 1: the columns (axis -2 holds the vertical frequencies)
    cols = _idct_1d(dq.unbind(-2))
    ws = torch.stack([_descale(v, CONST_BITS - PASS1_BITS).clamp(
        -0x8000, 0x7FFF) for v in cols], dim=-2)
    ac_zero = (x[..., 1:, :] == 0).all(-1).all(-1)[..., None, None]
    ws = torch.where(ac_zero, _wrap16(dq[..., :1, :] << PASS1_BITS), ws)
    # pass 2: the rows, then the samples
    rows = _idct_1d(ws.unbind(-1))
    pix = torch.stack([_sample(_descale(v, CONST_BITS + PASS1_BITS + 3))
                       for v in rows], dim=-1)
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
    """The GPU route's plain version on the CPU: :func:`decode_coefs`,
    :func:`smooth_coefs`, then :func:`idct_islow_u8_ref`,
    :func:`ycc_to_rgb_u8_ref` and :func:`resize_bilinear_u8_ref` -> (T, h,
    w, 3) u8 RGB, a grayscale frame's plane resized to three channels, as
    ``decode_video(device="cpu")`` gives it."""
    out = []
    for comps in decode_coefs(paths, n_threads):
        planes = [idct_islow_u8_ref(torch.from_numpy(smooth_coefs(c))[None],
                                    torch.from_numpy(c.qtable)[None],
                                    c.size)[0] for c in comps]
        src = (planes[0][..., None] if len(planes) == 1
               else ycc_to_rgb_u8_ref(*planes))
        out.append(resize_bilinear_u8_ref(src[None].contiguous(), size)[0])
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
        return frame.cpu().numpy() if isinstance(frame, torch.Tensor) else frame
