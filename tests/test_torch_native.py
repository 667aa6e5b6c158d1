"""PyTorch port: the native loader (``data/native.py``) against cv2 and the
JAX package's loader.

* ``decode_video`` (host route: the port's copy of the C++ loader, built
  with libjpeg) on grayscale and colour JPEGs written at 240x360 by cv2:
  within 1 LSB of cv2's decode + resize (``_decode_rgb``: cv2 resizes in
  fixed point, the loader in float) and bitwise the JAX package's
  ``native.decode_video`` (the same source; the port's build rounds the
  resize without fused multiply-adds, which no value of these files
  meets), and within 1 LSB of it on files where the JAX build's fused
  multiply-adds round a value otherwise (open fault C4 in ``ROADMAP.md``);
* ``load_flow_video`` against the JAX package's ``load_flow`` to 1e-6
  (cv2's float resize against the loader's), both bug modes, resized and
  not;
* missing, corrupt and non-JPEG files raise, and so does a loader that does
  not build (no cv2 stands in);
* the GPU route's plain versions: the resize within 1 LSB of cv2 and the
  colour conversion bitwise libjpeg's RGB decode on libjpeg's own planes;
  the kernels themselves run on the card (``tests/test_torch_cuda.py``);
* the committed fixture ``tests/fixtures/torch_jpeg`` is what its script
  says, and the host route decodes it within 1 LSB of its reference;
* the GPU route's plain versions end to end: the port's own Huffman decode
  (the host library's "coef" form), then the plain IDCT, colour conversion
  and resize, bitwise the host libjpeg route, at source size and at
  256x256, on the fixture and on cv2-written JPEGs (4:4:4, 4:2:2, 4:2:0,
  qualities 50 to 100, odd sizes, restart intervals) and libjpeg-written
  ones (non-interleaved scans, a restart marker at the end of every MCU
  row, progressive and arithmetic-coded scripts); lossless and 12-bit
  JPEGs raise their named errors; the plain IDCT is libjpeg's x86 SIMD
  build's arithmetic on chosen extreme coefficients (its saturation is
  jdmaster.c's range-limit table within +-512), and the SIMD build's
  shortcut gives what its full path gives;
* fault C5, repaired: a grayscale JPEG's plane resized to three channels
  (``resize_bilinear_u8_ref``) is the JAX loader's RGB decode
  bitwise, channel 0 with its own rounding, on ``gray_c5.jpg`` and on
  random sizes;
* fault C6, repaired: progressive scripts that libjpeg block-smooths at
  output (AC never refined, DC alone, AC 1-9 at Al = 1, chroma DC alone,
  arithmetic-coded; narrow and ragged sizes) decode bitwise through the
  coefficient route and ``smooth_coefs``;
* fault C7, repaired: truncated JPEGs (eight writers, cut at 10 to 99 %
  of their bytes) decode through the coefficient route bitwise as the
  host libjpeg route decodes them, or raise where it raises; one of them
  bitwise the JAX loader; a progressive cut whose smoothing reads the
  second latch row; a wrong or missing restart marker resyncs as libjpeg
  resyncs;
* without cv2 the cv2 loaders raise ``ImportError`` naming
  ``--native_loader``.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.data import native as jnative
from ammcnet_aaai2021_tpu.data.datasets import load_flow as j_load_flow
from ammcnet_aaai2021_torch.data import datasets, native
from ammcnet_aaai2021_torch.data.flo import read_flo, write_flo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
SHAPE = (240, 360)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """6 grayscale and 3 colour (4:2:0) JPEGs at 240x360, from a seed."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1]].astype(np.float32)
    out = {"gray": [], "color": []}
    for i in range(6):
        img = 120 + 70 * np.sin(xx / (13 + i)) * np.cos(yy / 29.0)
        img = np.clip(img + rng.normal(0, 4, SHAPE), 0, 255).astype(np.uint8)
        out["gray"].append(str(root / f"g{i}.jpg"))
        cv2.imwrite(out["gray"][-1], img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    for i in range(3):
        img = cv2.GaussianBlur(rng.integers(0, 256, (*SHAPE, 3), np.uint8),
                               (7, 7), 2)
        out["color"].append(str(root / f"c{i}.jpg"))
        cv2.imwrite(out["color"][-1], img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    return out


@pytest.mark.parametrize("kind", ["gray", "color"])
@pytest.mark.parametrize("size", [(64, 64), (256, 256)])
def test_decode_video_matches_cv2_and_the_jax_loader(jpegs, kind, size):
    paths = jpegs[kind]
    got = native.decode_video(paths, size)
    assert got.shape == (len(paths), *size, 3) and got.dtype == np.uint8
    want = np.stack([datasets._decode_rgb(p, size) for p in paths])
    assert int(np.abs(got.astype(int) - want).max()) <= 1
    if jnative.available():  # no value of these files meets C4
        np.testing.assert_array_equal(got, jnative.decode_video(paths, size))


@pytest.fixture(scope="module")
def flo_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("flo")
    rng = np.random.default_rng(6)
    paths = []
    for i in range(4):
        paths.append(str(root / f"{i:03d}.flo"))
        write_flo(paths[-1], rng.normal(0, 3, (24, 36, 2)).astype(np.float32))
    return paths


@pytest.mark.parametrize("size", [(24, 36), (64, 64)], ids=["native", "resized"])
@pytest.mark.parametrize("bug", [True, False])
def test_load_flow_video_matches_the_jax_loader(flo_files, bug, size):
    """Bitwise the JAX package's native loader (the resized case too: the
    port's host library writes out that build's fused multiply-adds), and
    within 1e-6 of its cv2 loader (cv2's float resize, a division where the
    native loaders multiply by a reciprocal)."""
    got = native.load_flow_video(flo_files, size, reproduce_bug=bug)
    assert got.shape == (4, *size, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jnative.load_flow_video(flo_files, size, reproduce_bug=bug))
    want = np.stack([j_load_flow(p, size, bug) for p in flo_files])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_missing_corrupt_and_foreign_files_raise(jpegs, flo_files, tmp_path):
    bad_jpg = tmp_path / "bad.jpg"
    bad_jpg.write_bytes(b"\xff\xd8\xff\xe0 not a jpeg" * 8)
    bad_flo = tmp_path / "bad.flo"
    bad_flo.write_bytes(np.float32(1.0).tobytes() * 16)
    short_flo = tmp_path / "short.flo"
    short_flo.write_bytes(open(flo_files[0], "rb").read()[:100])
    for paths, match in (([str(tmp_path / "missing.jpg")], "does not open"),
                         ([jpegs["gray"][0], str(bad_jpg)], "not a decodable")):
        with pytest.raises(RuntimeError, match=match):
            native.decode_video(paths, (64, 64))
    for paths, match in (([str(tmp_path / "missing.flo")], "does not open"),
                         ([str(bad_flo)], "bad magic"),
                         ([str(short_flo)], "truncated")):
        with pytest.raises(RuntimeError, match=match):
            native.load_flow_video(paths, (64, 64))
    with pytest.raises(ValueError, match="JPEG files only"):
        native.decode_video([str(tmp_path / "frame.npy")], (64, 64))
    with pytest.raises(ValueError, match=".flo files only"):
        native.load_flow_video([str(tmp_path / "flow.npy")], (64, 64))


@pytest.mark.parametrize("form", ["jpeg", "flo"])
def test_a_loader_that_does_not_build_raises(jpegs, flo_files, tmp_path,
                                             monkeypatch, form):
    """No cv2 or numpy path stands in for a loader that fails to build."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="building the native loader"):
        if form == "jpeg":
            native.decode_video(jpegs["gray"], (64, 64))
        else:
            native.load_flow_video(flo_files, (64, 64))


def test_gpu_decode_without_a_gpu_raises(jpegs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the GPU route would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.decode_video(jpegs["gray"], (64, 64), device="cuda")


@pytest.mark.parametrize("channels", [3, "1to3", "1as3"])
@pytest.mark.parametrize("src,size", [((240, 360), (256, 256)),
                                      ((37, 53), (64, 48)),
                                      ((64, 64), (64, 64))])
def test_resize_plain_version_matches_cv2(channels, src, size):
    """Three channels from 3, or from 1 ("1to3" against cv2's one-channel
    resize; "1as3": bitwise the resize of the plane repeated on three
    channels, and that against cv2's three-channel resize)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (2, *src, 3 if channels == 3 else 1),
                       np.uint8)
    got = native.resize_bilinear_u8(torch.from_numpy(img), size).numpy()
    assert got.shape == (2, *size, 3)
    if channels == "1as3":
        img = np.ascontiguousarray(np.repeat(img, 3, axis=3))
        np.testing.assert_array_equal(
            got, native.resize_bilinear_u8(torch.from_numpy(img),
                                           size).numpy())
    for frame, out in zip(img, got):
        want = cv2.resize(frame, (size[1], size[0])).reshape(
            (*size, img.shape[3]))
        assert int(np.abs(out.astype(int) - want).max()) <= 1


def test_cpu_wrappers_take_the_plain_versions_without_counting():
    img = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (1, 16, 24, 1), np.uint8))
    before = (native.resize_bilinear_u8.launches, native.ycc_to_rgb_u8.launches)
    assert torch.equal(native.resize_bilinear_u8(img, (8, 8)),
                       native.resize_bilinear_u8_ref(img, (8, 8)))
    y, c = img[0, ..., 0].contiguous(), img[0, ::2, ::2, 0].contiguous()
    assert torch.equal(native.ycc_to_rgb_u8(y, c, c),
                       native.ycc_to_rgb_u8_ref(y, c, c))
    assert (native.resize_bilinear_u8.launches,
            native.ycc_to_rgb_u8.launches) == before
    with pytest.raises(ValueError, match="4:2:0"):
        native.ycc_to_rgb_u8(y, c[:3], c[:3])


# libjpeg's raw component planes (no upsampling, no colour conversion),
# cropped to each component's downsampled size: <w int32><h int32><bytes>
RAW_PLANES_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  struct jpeg_decompress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_decompress(&c);
  jpeg_stdio_src(&c, f);
  jpeg_read_header(&c, TRUE);
  c.raw_data_out = TRUE;
  jpeg_start_decompress(&c);
  JSAMPARRAY bufs[3];
  unsigned char* planes[3];
  int done[3] = {0, 0, 0};
  for (int i = 0; i < c.num_components; i++) {
    int rows = c.comp_info[i].v_samp_factor * DCTSIZE;
    bufs[i] = malloc(sizeof(JSAMPROW) * rows);
    for (int r = 0; r < rows; r++)
      bufs[i][r] = malloc(c.comp_info[i].width_in_blocks * DCTSIZE);
    planes[i] = malloc((size_t)c.comp_info[i].downsampled_width
                       * c.comp_info[i].downsampled_height);
  }
  while (c.output_scanline < c.output_height) {
    jpeg_read_raw_data(&c, bufs, c.max_v_samp_factor * DCTSIZE);
    for (int i = 0; i < c.num_components; i++) {
      jpeg_component_info* ci = &c.comp_info[i];
      for (int r = 0; r < ci->v_samp_factor * DCTSIZE; r++, done[i]++)
        if (done[i] < (int)ci->downsampled_height)
          for (unsigned x = 0; x < ci->downsampled_width; x++)
            planes[i][(size_t)done[i] * ci->downsampled_width + x] = bufs[i][r][x];
    }
  }
  for (int i = 0; i < c.num_components; i++) {
    int wh[2] = {(int)c.comp_info[i].downsampled_width,
                 (int)c.comp_info[i].downsampled_height};
    fwrite(wh, 4, 2, o);
    fwrite(planes[i], 1, (size_t)wh[0] * wh[1], o);
  }
  fclose(o);
  return 0;
}
"""


def _raw_planes(helper, path, tmp_path):
    out = tmp_path / (os.path.basename(path) + ".raw")
    subprocess.run([str(helper), path, str(out)], check=True)
    data, planes, off = out.read_bytes(), [], 0
    while off < len(data):
        w, h = np.frombuffer(data[off:off + 8], np.int32)
        planes.append(torch.from_numpy(np.frombuffer(
            data[off + 8:off + 8 + w * h], np.uint8).reshape(h, w).copy()))
        off += 8 + w * h
    return planes


@pytest.mark.parametrize("subsampling", ["420", "422", "444"])
def test_colour_plain_version_is_libjpegs_conversion(tmp_path, subsampling):
    """On libjpeg's own decoded planes, the colour kernel's plain version
    (fancy upsampling, fixed-point YCbCr -> RGB) gives cv2's RGB decode
    bitwise, at an odd size (ragged chroma edges), one frame a call and a
    chunk of three frames a call."""
    helper = tmp_path / "raw_planes"
    src = tmp_path / "raw_planes.c"
    src.write_text(RAW_PLANES_C)
    subprocess.run(["gcc", "-O2", str(src), "-o", str(helper), "-ljpeg"],
                   check=True)
    rng = np.random.default_rng(9)
    img = cv2.GaussianBlur(rng.integers(0, 256, (61, 97, 3), np.uint8),
                           (5, 5), 2)
    img[10:30, 20:41] = (250, 10, 30)  # a sharp chroma edge
    path = str(tmp_path / f"f{subsampling}.jpg")
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{subsampling}")
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    y, cb, cr = _raw_planes(helper, path, tmp_path)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(native.ycc_to_rgb_u8(y, cb, cr).numpy(),
                                  want)
    # a chunk of frames in one call (the GPU route's one launch a chunk):
    # libjpeg's planes, their mirror images and seeded noise, each frame
    # as its own call gives it, and libjpeg's frame bitwise
    noise = [torch.from_numpy(rng.integers(0, 256, p.shape, np.uint8))
             for p in (y, cb, cr)]
    chunk = [torch.stack([p, p.flip(-1), n]) for p, n in zip((y, cb, cr),
                                                               noise)]
    got = native.ycc_to_rgb_u8(*chunk)
    assert got.shape == (3, *y.shape, 3)
    for i in range(3):
        assert torch.equal(got[i], native.ycc_to_rgb_u8_ref(
            *(p[i].contiguous() for p in chunk)))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_fixture_is_its_scripts_output_and_decodes_within_1_lsb():
    """``reference.npz`` is cv2's decode + resize of the committed JPEGs, and
    the host route decodes them within 1 LSB of it (the card holds its GPU
    route against the same file)."""
    ref = np.load(os.path.join(FIXTURE, "reference.npz"))
    assert ref["gray"].shape == (16, 256, 256)
    assert ref["color"].shape == (2, 256, 256, 3)
    size = sum(os.path.getsize(os.path.join(FIXTURE, f))
               for f in os.listdir(FIXTURE))
    assert size < 3_000_000
    for kind, want in (("gray", ref["gray"][..., None]),
                       ("color", ref["color"])):
        paths = [os.path.join(FIXTURE, f"{kind}_{i:02d}.jpg")
                 for i in range(len(want))]
        cv2_out = np.stack([datasets._decode_rgb(p, (256, 256))
                            for p in paths])
        np.testing.assert_array_equal(np.broadcast_to(want, cv2_out.shape),
                                      cv2_out)
        got = native.decode_video(paths, (256, 256))
        assert int(np.abs(got.astype(int) - want).max()) <= 1
        if kind == "gray":
            assert got.shape[1:3] == (256, 256)
            assert cv2.imread(paths[0]).shape[:2] == SHAPE


def test_cv2_loaders_without_cv2_name_the_native_loader(jpegs, flo_files,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    with pytest.raises(ImportError, match="--native_loader"):
        datasets._decode_rgb(jpegs["gray"][0], (64, 64))
    with pytest.raises(ImportError, match="--native_loader"):
        datasets.load_flow(flo_files[0], (64, 64))
    # what needs no cv2 still runs without it
    assert datasets.load_flow(flo_files[0], (24, 36)).shape == (24, 36, 2)


# cv2-written JPEGs for the coefficient route: a blurred noise image with
# flat, saturated and sharp-chroma patches, and a 0/255 checkerboard whose
# high-quality IDCT overshoots [0, 255] (the range limit's clamp)
ODD_SHAPE = (241, 359)


@pytest.fixture(scope="module")
def coef_images():
    rng = np.random.default_rng(21)
    img = cv2.GaussianBlur(rng.integers(0, 256, (*ODD_SHAPE, 3), np.uint8),
                           (5, 5), 1.5)
    img[20:60, 30:90] = 255
    img[100:140, 200:260] = 0
    img[150:170, 10:40] = (250, 10, 30)
    yy, xx = np.mgrid[0:ODD_SHAPE[0], 0:ODD_SHAPE[1]]
    board = np.where(((yy // 3) + (xx // 3)) % 2 == 0, 255, 0).astype(np.uint8)
    return {"scene": img, "board": np.repeat(board[..., None], 3, axis=2)}


def _host_equals_coef_route(paths, shape):
    for size in (shape, (256, 256)):
        want = native.decode_video(paths, size)
        got = native.decode_video_ref(paths, size).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{size}")


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", ["444", "422", "420"])
def test_coef_route_is_the_host_route_on_colour(coef_images, tmp_path,
                                                subsampling, quality):
    """cv2's colour JPEGs at an odd size: the coefficient decode, the plain
    IDCT, colour conversion and resize equal libjpeg's decode and the host
    resize bitwise, at source size and at 256x256."""
    path = str(tmp_path / "c.jpg")
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{subsampling}")
    cv2.imwrite(path, coef_images["scene"], [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        flag])
    _host_equals_coef_route([path], ODD_SHAPE)


@pytest.mark.parametrize("subsampling,quality", [("422", 50), ("422", 75),
                                                 ("420", 50), ("420", 75)])
def test_host_route_is_bitwise_the_jax_loader(coef_images, tmp_path,
                                              subsampling, quality):
    """Fault C4 (``ROADMAP.md``), repaired: the JAX package's loader, built
    ``-O3 -march=native``, lets g++ fuse some of the resize's products into
    FMAs; the port's host library writes those fusions out with
    ``std::fmaf`` (built ``-ffp-contract=off``), its kernel with
    ``__fmaf_rn``, so at source size and at 256x256 the port's host route
    is the JAX loader's decode bitwise (these four files differed by 1 LSB
    on 0 to 2 of 196,608 values while the port rounded every product)."""
    path = str(tmp_path / "c.jpg")
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{subsampling}")
    cv2.imwrite(path, coef_images["scene"], [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        flag])
    for size in (ODD_SHAPE, (256, 256)):
        np.testing.assert_array_equal(native.decode_video([path], size),
                                      jnative.decode_video([path], size))


# a resize whose half-pixel map the fused fx = fmaf(x + 0.5, scale, -0.5)
# moves (at 256x256 the scale is a multiple of 1/256 and the unfused
# product is exact too)
FMA_SIZE = (279, 295)


@pytest.mark.parametrize("kind", ["u8", "flow"])
def test_plain_resizes_are_the_host_library_where_the_fused_map_differs(
        coef_images, flo_files, tmp_path, kind):
    """``resize_bilinear_u8_ref`` and ``resize_bilinear_f32_ref`` against
    the host library (and it against the JAX loader), bitwise, at a size
    where the fused half-pixel map gives other weights than a rounded
    product and difference would."""
    src_hw = ODD_SHAPE if kind == "u8" else (24, 36)
    for n, m in zip(src_hw, FMA_SIZE):
        x = torch.arange(m, dtype=torch.float32) + 0.5
        scale = float(np.float32(n) / np.float32(m))
        fused = native._fmaf(x, torch.full_like(x, scale),
                             torch.full_like(x, -0.5))
        assert (fused != x * scale - 0.5).any(), (n, m)
    if kind == "u8":
        path = str(tmp_path / "c.jpg")
        cv2.imwrite(path, coef_images["scene"], [cv2.IMWRITE_JPEG_QUALITY, 90])
        src = torch.from_numpy(native.decode_video([path], ODD_SHAPE))
        host = native.decode_video([path], FMA_SIZE)
        np.testing.assert_array_equal(host,
                                      jnative.decode_video([path], FMA_SIZE))
        got = native.resize_bilinear_u8_ref(src, FMA_SIZE).numpy()
    else:
        flows = torch.from_numpy(np.stack([read_flo(p) for p in flo_files]))
        host = native.load_flow_video(flo_files, FMA_SIZE, reproduce_bug=False)
        np.testing.assert_array_equal(host, jnative.load_flow_video(
            flo_files, FMA_SIZE, reproduce_bug=False))
        inv = torch.tensor([1 / np.float32(FMA_SIZE[1]),
                            1 / np.float32(FMA_SIZE[0])], dtype=torch.float32)
        got = (native.resize_bilinear_f32_ref(flows, FMA_SIZE) * inv).numpy()
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("case", ["gray_q50", "gray_q95", "board_q95",
                                  "board_q100", "rst_420", "rst_gray"])
def test_coef_route_is_the_host_route(coef_images, tmp_path, case):
    """Grayscale JPEGs, the checkerboard at q 95 and 100 (IDCT sums past
    [0, 255]: the range limit), and restart intervals of 3 MCUs."""
    kind, tag = case.split("_")
    img = coef_images["board" if kind == "board" else "scene"]
    params = []
    if tag.startswith("q"):
        params = [cv2.IMWRITE_JPEG_QUALITY, int(tag[1:])]
    else:
        params = [cv2.IMWRITE_JPEG_QUALITY, 90,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
    if "gray" in case:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    path = str(tmp_path / f"{case}.jpg")
    cv2.imwrite(path, img, params)
    if kind == "board":
        # the checkerboard's IDCT does overshoot: the range limit clamps
        comps = native.decode_coefs([path])[0]
        c = comps[0]
        raw = _idct_unclamped(torch.from_numpy(c.coefs)[None],
                              torch.from_numpy(c.qtable)[None])
        assert raw.min() < -128 and raw.max() > 127
    _host_equals_coef_route([path], ODD_SHAPE)


# libjpeg_reference.npz's kinds: baseline gray and colour frames, a
# progressive and an arithmetic-coded one, C5's grayscale JPEG, and the
# progressive files libjpeg block-smooths (C6); each kind's sizes
REFERENCE_SIZES = {"gray": ["source", "256"], "color": ["source", "256"],
                   "progressive": ["256"], "arithmetic": ["source", "256"],
                   "gray_c5": ["160", "248x103", "256"],
                   "smooth_partial": ["source", "256"],
                   "smooth_dconly": ["source", "256"],
                   "smooth_al1": ["source", "256"],
                   "smooth_arith": ["source", "256"],
                   "trunc_rst": ["source", "256"],
                   "trunc_progressive": ["source", "256"],
                   "trunc_arith": ["source", "256"]}
# the kinds libjpeg block-smooths at output
SMOOTHED = {"smooth_partial", "smooth_dconly", "smooth_al1", "smooth_arith",
            "trunc_progressive", "trunc_arith"}


def fixture_paths(kind):
    """The committed fixture's JPEGs of one ``libjpeg_reference.npz`` kind."""
    if kind in ("gray", "color"):
        return [os.path.join(FIXTURE, f"{kind}_{i:02d}.jpg")
                for i in range({"gray": 16, "color": 2}[kind])]
    return [os.path.join(FIXTURE, f"{kind}.jpg")]


@pytest.mark.parametrize("kind", list(REFERENCE_SIZES))
def test_coef_route_is_the_committed_libjpeg_reference(kind, monkeypatch):
    """The fixture's ``libjpeg_reference.npz`` is the host route's decode,
    three channels a frame, bitwise the JAX loader's, and the coefficient
    route gives it bitwise (the card holds its GPU route against the same
    file): the baseline frames, the progressive one (SOF2, kept at 256x256
    alone), the arithmetic-coded progressive one (SOF10, grayscale),
    ``gray_c5.jpg`` (at 160x160 and 248x103 its channel 0 is off channels 1
    and 2 where
    the JAX loader's build rounds it so: C5), the smoothing files (C6:
    libjpeg smooths each, and unsmoothed they would decode otherwise) and
    the truncated files (C7)."""
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    paths = fixture_paths(kind)
    names = [k[len(kind) + 1:] for k in ref.files
             if k.startswith(f"{kind}_") and k[len(kind) + 1:] in (
                 "source", "160", "248x103", "256")]
    assert names == REFERENCE_SIZES[kind]
    for name in names:
        want = ref[f"{kind}_{name}"]
        size = want.shape[1:3]
        assert want.shape == (len(paths), *size, 3)
        host = native.decode_video(paths, size)
        np.testing.assert_array_equal(want, host)
        np.testing.assert_array_equal(want, jnative.decode_video(paths, size))
        got = native.decode_video_ref(paths, size).numpy()
        np.testing.assert_array_equal(got, host)
        if kind == "gray_c5" and name != "256":
            assert (want[..., 0] != want[..., 1]).any()
            assert np.array_equal(want[..., 1], want[..., 2])
    comps = native.decode_coefs(paths)[0]
    assert all(c.smooth for c in comps) == (kind in SMOOTHED)
    if kind.startswith("smooth"):
        unsmoothed = _unsmoothed_decode(monkeypatch, paths[0],
                                        want.shape[1:3])
        assert not np.array_equal(unsmoothed, want)


def _unsmoothed_decode(monkeypatch, path, size):
    """The coefficient route without libjpeg's block smoothing."""
    with monkeypatch.context() as m:
        m.setattr(native, "smooth_coefs", lambda comp: comp.coefs)
        return native.decode_video_ref([path], size).numpy()


# fault C5 (ROADMAP.md): grayscale noise JPEGs at random sizes, written by
# cv2 at quality 95, resized to random sizes; image i of this loop.  The
# JAX loader's channel 0 is 1 LSB off channels 1 and 2 on images 22, 34,
# 80, 95, 125 and 139 (and on 119, 127, 128 and 129); 0 and 1 show none.
def _c5_image(i):
    rng = np.random.default_rng(5)
    for _ in range(i + 1):
        h, w = rng.integers(16, 200, 2)
        size = tuple(int(v) for v in rng.integers(16, 300, 2))
        img = rng.integers(0, 256, (h, w), np.uint8)
    return img, size


@pytest.mark.parametrize("image", [22, 34, 80, 95, 125, 139, 0, 1])
def test_gray_jpeg_is_the_jax_loaders_rgb(tmp_path, image):
    """Fault C5, repaired: the host route and the GPU route's plain version
    (one plane, resized to three channels) give the JAX loader's RGB
    decode of a grayscale JPEG bitwise, channel 0 included."""
    img, size = _c5_image(image)
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    want = jnative.decode_video([path], size)
    assert (want[..., 0] != want[..., 1]).any() == (image > 1)
    np.testing.assert_array_equal(native.decode_video([path], size), want)
    np.testing.assert_array_equal(native.decode_video_ref([path],
                                                          size).numpy(), want)
    # the plain resize of the one plane to three channels is the
    # three-channel resize of the plane repeated
    plane = torch.from_numpy(np.ascontiguousarray(
        native.decode_video([path], img.shape)[..., :1]))
    np.testing.assert_array_equal(
        native.resize_bilinear_u8(plane, size).numpy(), want)



@pytest.mark.parametrize("dw", [256, 248])
def test_c5_needs_a_width_that_is_not_a_power_of_two(dw):
    """Why ``gray_c5.jpg`` shows C5 at 160x160 and 248x103 and no JPEG can
    at 256x256: at a power-of-two width every horizontal weight of a source
    16 to 720 wide is a multiple of 1/512, so both orders in which the
    host's build fuses a lerp (``fmaf(1 - w, a, w * b)``, and channel 0's
    ``fmaf(w, b, (1 - w) * a)``) are exact and equal for every pair of
    bytes; at 248 some differ."""
    w = torch.unique(torch.cat([native._axis_map(sw, dw, "cpu")[2]
                                for sw in range(16, 721)]))
    v = torch.arange(256, dtype=torch.float32)
    a, b = v[None, :, None], v[None, None, :]
    differ = 0
    for chunk in w.split(32):
        wk = chunk[:, None, None]
        differ += int((native._fmaf(1 - wk, a, wk * b)
                       != native._fmaf(wk, b, (1 - wk) * a)).sum())
        if differ:
            break
    assert (differ == 0) == (dw == 256)
    if dw == 256:
        assert torch.equal(w * 512, torch.round(w * 512))


@pytest.fixture(scope="module")
def libjpeg_writer(tmp_path_factory):
    """libjpeg writing what cv2 cannot ask for (``scripts/libjpeg_write.c``
    names the modes): ``write(img, mode, path)``, a 2-D image as a
    grayscale JPEG."""
    root = tmp_path_factory.mktemp("writer")
    subprocess.run(["gcc", "-O2", os.path.join(REPO, "scripts",
                                               "libjpeg_write.c"),
                    "-o", str(root / "libjpeg_write"), "-ljpeg"], check=True)

    def write(img, mode, path):
        raw = path + ".raw"
        gray = img.ndim == 2
        # BGR -> RGB
        np.ascontiguousarray(img if gray else img[..., ::-1]).tofile(raw)
        subprocess.run([str(root / "libjpeg_write"), raw, str(img.shape[1]),
                        str(img.shape[0]), path, mode]
                       + (["gray"] if gray else []), check=True)
        return path

    return write


@pytest.mark.parametrize("mode", ["nonint", "rowrst"])
def test_coef_route_takes_what_cv2_does_not_write(coef_images,
                                                  libjpeg_writer, tmp_path,
                                                  mode):
    """Non-interleaved scans (each component's blocks, not the MCU grid, at
    an odd size) with restart intervals, and a restart marker at the end of
    every MCU row: bitwise the host route."""
    path = libjpeg_writer(coef_images["scene"], mode, str(tmp_path / "f.jpg"))
    _host_equals_coef_route([path], ODD_SHAPE)


def _scene(coef_images, kind):
    img = coef_images["scene"]
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if kind == "gray" else img


@pytest.mark.parametrize("case", [
    "cv2_progressive-gray", "cv2_progressive-color", "arith-gray",
    "arith-color", "sof10-gray", "sof10-color", "fixture-color"])
def test_coef_route_is_the_host_route_on_progressive_and_arithmetic(
        coef_images, libjpeg_writer, tmp_path, case):
    """Fault C3, repaired: a progressive (SOF2) frame written by cv2, an
    arithmetic-coded sequential (SOF9) and an arithmetic-coded progressive
    (SOF10) one written by libjpeg, gray and 4:2:0 colour, and the
    committed ``progressive.jpg``: the coefficient decode, the plain IDCT,
    colour conversion and resize equal libjpeg's decode and the host resize
    bitwise, at source size and at 256x256."""
    source, kind = case.split("-")
    path = str(tmp_path / f"{case}.jpg")
    if source == "fixture":
        path = os.path.join(FIXTURE, "progressive.jpg")
        shape = cv2.imread(path).shape[:2]
    else:
        img = _scene(coef_images, kind)
        shape = ODD_SHAPE
        if source == "cv2_progressive":
            cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        else:
            libjpeg_writer(img, source, path)
    frame = {"cv2_progressive": 0xC2, "arith": 0xC9, "sof10": 0xCA,
             "fixture": 0xC2}[source]
    assert bytes([0xFF, frame]) in open(path, "rb").read()
    _host_equals_coef_route([path], shape)


@pytest.mark.parametrize("mode", ["progrst", "arithrst", "sof10rst", "sa",
                                  "sarst"])
@pytest.mark.parametrize("kind", ["gray", "color"])
def test_coef_route_takes_restarts_and_successive_approximation(
        coef_images, libjpeg_writer, tmp_path, mode, kind):
    """Restart intervals inside progressive Huffman scans (EOB runs end at
    each), inside arithmetic sequential and progressive scans (statistics
    reset at each), and a deeper successive-approximation script (three DC
    stages, split AC bands, AC refined in three stages), with and without
    restarts: bitwise the host route."""
    path = libjpeg_writer(_scene(coef_images, kind), mode,
                          str(tmp_path / "f.jpg"))
    _host_equals_coef_route([path], ODD_SHAPE)


@pytest.mark.parametrize("case", ["lossless", "12bit"])
def test_coef_route_names_what_it_does_not_take(coef_images, tmp_path, case):
    """A lossless header (SOF3) raises code 11 and a 12-bit one code 13, as
    libjpeg's 8-bit decoder refuses both."""
    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, coef_images["scene"])
    data = bytearray(open(path, "rb").read())
    sof = data.index(b"\xff\xc0")
    if case == "lossless":
        data[sof + 1] = 0xC3
        code = 11
    else:
        data[sof + 4] = 12  # the sample precision byte
        code = 13
    open(path, "wb").write(bytes(data))
    with pytest.raises(RuntimeError, match=f"code {code}: "
                       + native.ERRORS[code]):
        native.decode_coefs([path])


@pytest.mark.parametrize("case", [
    "partial-gray", "partial-color", "dconly-gray", "dconly-color",
    "al1-gray", "al1-color", "chromadc-color", "arithpartial-gray",
    "arithpartial-color", "partial-narrow", "dconly-narrow"])
def test_coef_route_smooths_as_libjpeg(coef_images, libjpeg_writer, tmp_path,
                                       monkeypatch, case):
    """Fault C6, repaired: progressive scripts that leave one of the first
    ten coefficients unrefined, which libjpeg-turbo block-smooths at output
    (``scripts/libjpeg_write.c`` modes: AC never refined past Al = 1, the
    DC alone, AC 1-9 at Al = 1, chroma DC alone, ``partial``
    arithmetic-coded), gray and 4:2:0 colour at an odd size, and 2 blocks
    wide (the column registers' edge): the coefficient route with
    ``smooth_coefs`` is the host libjpeg route bitwise, and without the
    smoothing it would not be."""
    mode, kind = case.split("-")
    img = _scene(coef_images, "gray" if kind == "narrow" else kind)
    if kind == "narrow":
        img = img[:61, :15]
    path = libjpeg_writer(img, mode, str(tmp_path / "f.jpg"))
    comps = native.decode_coefs([path])[0]
    assert all(c.smooth for c in comps)
    _host_equals_coef_route([path], img.shape[:2])
    assert not np.array_equal(
        _unsmoothed_decode(monkeypatch, path, img.shape[:2]),
        native.decode_video([path], img.shape[:2]))


def _idct_unclamped(coefs, qtables):
    """The plain IDCT's descaled values before the range limit."""
    f, bh, bw, _ = coefs.shape
    q = qtables.to(torch.int16).to(torch.int32).view(f, 1, 1, 8, 8)
    x = coefs.to(torch.int32).view(f, bh, bw, 8, 8) * q
    ws = torch.stack([native._descale(v, 11) for v in
                      native._idct_1d(x.unbind(-2))], dim=-2)
    return torch.stack([native._descale(v, 18) for v in
                        native._idct_1d(ws.unbind(-1))], dim=-1)


def test_range_limit_is_jdmasters_table():
    """jdmaster.c prepare_range_limit_table, built as libjpeg builds it and
    indexed as jidctint.c indexes it (``x & RANGE_MASK`` past
    ``CENTERJSAMPLE``), is the plain IDCT's last step (the SIMD build's
    saturation to [-128, 127] and + CENTERJSAMPLE, ``native._sample``) for
    every descaled value -512 <= x < 512; beyond, jidctint.c's table wraps
    where the SIMD build, which the host's libjpeg runs, saturates."""
    table = np.zeros(5 * 256 + 128, np.int64)
    base = 256  # table + (MAXJSAMPLE + 1): sample_range_limit
    table[base:base + 256] = np.arange(256)
    idct = base + 128  # the post-IDCT table
    table[idct + 128:idct + 512] = 255
    table[idct + 512:idct + 1024 - 128] = 0
    table[idct + 1024 - 128:idct + 1024] = table[base:base + 128]
    x = np.arange(-2048, 2048)
    got = native._sample(torch.from_numpy(x)).numpy()
    inside = (x >= -512) & (x < 512)
    np.testing.assert_array_equal(got[inside], table[idct + (x[inside] & 1023)])
    np.testing.assert_array_equal(got[~inside], np.where(x[~inside] < 0, 0, 255))
    assert (got[~inside] != table[idct + (x[~inside] & 1023)]).any()


def test_plain_idct_zero_ac_shortcuts_give_the_full_path():
    """The SIMD build's one shortcut (pass 1 of a block whose rows 1-7 are
    all zero: the dequantized row 0 << PASS1_BITS in 16-bit lanes) gives
    what its full pass 1 gives (descaled and saturated to 16 bits) for
    every row-0 value a valid JPEG can hold, with AC terms in row 0; so do
    jidctint.c's shortcuts (a column of zero AC terms is its DC <<
    PASS1_BITS; a row of zero AC terms is range_limit(DESCALE(dc,
    PASS1_BITS + 3))).  Where row 0 << PASS1_BITS leaves 16 bits the lanes
    wrap, and the plain version wraps as the SIMD build does."""
    dc = torch.arange(-2048, 2048, dtype=torch.int16)
    n = dc.numel()
    coefs = torch.zeros((1, 1, n, 64), dtype=torch.int16)
    coefs[0, 0, :, 0] = dc
    # an AC term in column 1 of row 0: the block still takes the shortcut
    coefs[0, 0, :, 1] = torch.arange(n, dtype=torch.int16) % 7 - 3
    q = torch.full((1, 64), 1, dtype=torch.uint16)
    x = coefs.to(torch.int32).view(1, 1, n, 8, 8)
    full = torch.stack([native._descale(v, 11).clamp(-32768, 32767)
                        for v in native._idct_1d(x.unbind(-2))], dim=-2)
    short = (x[..., 0:1, :] * 4).expand_as(full)  # DC << PASS1_BITS
    assert torch.equal(full, short)
    assert torch.equal(native._wrap16(short), short)
    # blocks with a DC alone: every row takes jidctint.c's pass-2 shortcut
    flat = coefs.clone()
    flat[..., 1] = 0
    shortcut = native._sample(native._descale(dc.to(torch.int32) * 4, 5))
    plane = native.idct_islow_u8_ref(flat, q, (8, 8 * n))
    assert torch.equal(plane.view(8, n, 8),
                       shortcut.view(1, n, 1).expand(8, n, 8))
    # a DC of 2047 at a quantizer of 8: 16,376 << 2 wraps to -32 in 16
    # bits (a value of -1 after pass 2, sample 127), where saturation would
    # give 32,767 (sample 255)
    big = torch.zeros((1, 1, 1, 64), dtype=torch.int16)
    big[..., 0] = 2047
    got = native.idct_islow_u8_ref(big, torch.full((1, 64), 8,
                                                   dtype=torch.uint16), (8, 8))
    assert torch.equal(got, torch.full((1, 8, 8), 127, dtype=torch.uint8))


# fault C7 (ROADMAP.md): truncated JPEGs, the scene at an odd size written
# by cv2 at quality 90 (baseline, progressive, a restart interval of 4
# MCUs) or by scripts/libjpeg_write.c (arithmetic-coded sequential with
# restarts, "arithrst"; arithmetic-coded progressive, "sof10"), then cut
TRUNCATED_CASES = ["baseline-color", "baseline-gray", "progressive-color",
                   "progressive-gray", "rst-color", "progrst-color",
                   "arithrst-color", "sof10-color"]
CUTS = [10, 30, 50, 70, 90, 99]


def _truncated(coef_images, libjpeg_writer, tmp_path, case, cut):
    """``case``'s file cut to its first ``cut`` per cent of bytes."""
    writer, kind = case.split("-")
    img = _scene(coef_images, kind)
    full = str(tmp_path / f"{case}.jpg")
    if writer in ("arithrst", "sof10"):
        libjpeg_writer(img, writer, full)
    else:
        params = [cv2.IMWRITE_JPEG_QUALITY, 90]
        if writer.startswith("prog"):
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if writer.endswith("rst"):
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 4]
        cv2.imwrite(full, img, params)
    data = open(full, "rb").read()
    path = str(tmp_path / f"{case}_{cut}.jpg")
    open(path, "wb").write(data[:len(data) * cut // 100])
    return path


def _coef_route(paths, size):
    """The GPU route's structure on the CPU: the coefficient decode and
    ``smooth_coefs``, then one call of the IDCT's wrapper a component and
    one of the colour and resize wrappers for the frames (CPU tensors take
    the plain versions)."""
    frames = native.decode_coefs(paths)
    planes = [native.idct_islow_u8(
        torch.from_numpy(np.stack([native.smooth_coefs(c) for c in comps])),
        torch.from_numpy(np.stack([c.qtable for c in comps])), comps[0].size)
        for comps in zip(*frames)]
    src = (planes[0][..., None] if len(planes) == 1
           else native.ycc_to_rgb_u8(*planes))
    return native.resize_bilinear_u8(src.contiguous(), size).numpy()


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("case", TRUNCATED_CASES)
def test_truncated_jpeg_decodes_as_libjpeg(coef_images, libjpeg_writer,
                                           tmp_path, case, cut):
    """Fault C7, repaired: a file cut to its first 10 to 99 % of bytes
    decodes through ``decode_video_ref`` and through the coefficient route
    (:func:`_coef_route`) bitwise as the host libjpeg route decodes it, at
    source size and at 256x256: a Huffman scan's MCUs past the end
    skipped (zero blocks in a sequential frame, what earlier scans left in
    a progressive one), the EOI left unread at a restart boundary (no
    longer code 3), an arithmetic scan decoding zero bytes on, the rows
    past the last good one block-smoothed with the coefficient bits from
    before the cut scan, the IDCT saturating as libjpeg's SIMD build does.
    Where libjpeg refuses a cut (a header segment cut short), both raise."""
    path = _truncated(coef_images, libjpeg_writer, tmp_path, case, cut)
    for size in (ODD_SHAPE, (256, 256)):
        try:
            want = native.decode_video([path], size)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                native.decode_video_ref([path], size)
            with pytest.raises(RuntimeError):
                _coef_route([path], size)
            continue
        np.testing.assert_array_equal(
            native.decode_video_ref([path], size).numpy(), want,
            err_msg=f"{size}")
        np.testing.assert_array_equal(_coef_route([path], size), want,
                                      err_msg=f"{size}")


def test_truncated_jpeg_is_the_jax_loaders(coef_images, libjpeg_writer,
                                           tmp_path):
    """A colour JPEG with restarts cut at half its bytes: the host route,
    ``decode_video_ref`` and the JAX package's loader give the same bytes
    at source size and at 256x256 (the port raised code 3 at the first
    restart boundary past the cut)."""
    path = _truncated(coef_images, libjpeg_writer, tmp_path, "rst-color", 50)
    for size in (ODD_SHAPE, (256, 256)):
        want = jnative.decode_video([path], size)
        np.testing.assert_array_equal(native.decode_video([path], size), want)
        np.testing.assert_array_equal(
            native.decode_video_ref([path], size).numpy(), want)


def test_truncated_progressive_smooths_with_the_second_latch_row():
    """``trunc_progressive.jpg`` (cv2's progressive script cut inside its
    second scan, luma AC 1-5): libjpeg smooths the iMCU rows past the last
    good one (5 of 9) with each component's coefficient bits from before
    its last scan -- luma's DC-only bits, chroma's 0s, its last scan being
    the frame's first -- so a decode that latches one row gets 22,747 of
    81,600 values wrong at source size and 54,982 of 196,608 at 256x256;
    the two-row latch gives the host route bitwise."""
    path = os.path.join(FIXTURE, "trunc_progressive.jpg")
    comps = native.decode_coefs([path])[0]
    assert all(c.smooth and c.last_good_imcu == 5 and c.imcu_rows == 9
               for c in comps)
    assert list(comps[0].prev_coef_bits[1:]) == [-1] * 9
    assert all(list(c.prev_coef_bits[1:]) == [0] * 9 for c in comps[1:])
    for size, wrong in (((136, 200), 22_747), ((256, 256), 54_982)):
        want = native.decode_video([path], size)
        np.testing.assert_array_equal(
            native.decode_video_ref([path], size).numpy(), want)
        one_row = [c._replace(prev_coef_bits=c.coef_bits) for c in comps]
        planes = [native.idct_islow_u8_ref(
            torch.from_numpy(native.smooth_coefs(c))[None],
            torch.from_numpy(c.qtable)[None], c.size)[0] for c in one_row]
        got = native.resize_bilinear_u8_ref(
            native.ycc_to_rgb_u8_ref(*planes)[None].contiguous(), size)
        assert int((got.numpy() != want).sum()) == wrong


# libjpeg writing chosen coefficients (jpeg_write_coefficients): a
# grayscale JPEG of bh x bw blocks from <in.bin> (64 uint16 quantizers in
# natural order, then the blocks' int16 coefficients in natural order), its
# table 16-bit where a quantizer passes 255, Huffman tables optimized
WRITE_COEFS_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
int main(int argc, char** argv) {
  int bh = atoi(argv[3]), bw = atoi(argv[4]);
  FILE* f = fopen(argv[1], "rb");
  unsigned short q[64];
  short* co = malloc((size_t)bh * bw * 128);
  if (fread(q, 2, 64, f) != 64 ||
      fread(co, 2, (size_t)bh * bw * 64, f) != (size_t)bh * bw * 64) return 1;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* o = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, o);
  c.image_width = bw * 8;
  c.image_height = bh * 8;
  c.input_components = 1;
  c.in_color_space = JCS_GRAYSCALE;
  jpeg_set_defaults(&c);
  c.optimize_coding = TRUE;
  unsigned int table[64];
  for (int i = 0; i < 64; i++) table[i] = q[i];
  jpeg_add_quant_table(&c, 0, table, 100, FALSE);
  jvirt_barray_ptr arr = c.mem->request_virt_barray(
      (j_common_ptr)&c, JPOOL_IMAGE, TRUE, bw, bh, 1);
  jpeg_write_coefficients(&c, &arr);
  for (int r = 0; r < bh; r++) {
    JBLOCKARRAY row = c.mem->access_virt_barray((j_common_ptr)&c, arr, r, 1,
                                                TRUE);
    for (int b = 0; b < bw; b++)
      for (int k = 0; k < 64; k++)
        row[0][b][k] = co[((size_t)r * bw + b) * 64 + k];
  }
  jpeg_finish_compress(&c);
  fclose(o);
  return 0;
}
"""


@pytest.mark.parametrize("qmax", [1, 255, 4095, 32767])
def test_plain_idct_is_libjpegs_simd_idct(tmp_path, qmax):
    """The plain IDCT against the host's libjpeg on blocks written with
    chosen coefficients (any a baseline Huffman coder takes: DC steps
    within 11 bits, AC within 10) and tables of quantizers up to ``qmax``:
    bitwise, where 16-bit lanes wrap and saturate and sums pass +-512
    (jidctint.c's range limit, which wraps there, differs on many of these
    values), blocks with and without the SIMD build's shortcut."""
    helper = tmp_path / "write_coefs"
    src = tmp_path / "write_coefs.c"
    src.write_text(WRITE_COEFS_C)
    subprocess.run(["gcc", "-O2", str(src), "-o", str(helper), "-ljpeg"],
                   check=True)
    rng = np.random.default_rng(qmax)
    bh, bw = 8, 32
    n = bh * bw
    q = rng.integers(1, qmax + 1, 64)
    density = rng.uniform(0, 1, (n, 1))
    scale = rng.choice([3, 30, 300, 1023], (n, 1))
    c = rng.integers(-1023, 1024, (n, 64)) * scale // 1023
    c = np.where(rng.uniform(0, 1, (n, 64)) < density, c, 0)
    c[rng.uniform(0, 1, n) < 0.25, 8:] = 0  # rows 1-7 zero: the shortcut
    dc = np.clip(np.cumsum(rng.integers(-1500, 1501, n)), -2047, 2047)
    c[:, 0] = dc
    (tmp_path / "in.bin").write_bytes(q.astype(np.uint16).tobytes()
                                      + c.astype(np.int16).tobytes())
    path = str(tmp_path / "c.jpg")
    subprocess.run([str(helper), str(tmp_path / "in.bin"), path, str(bh),
                    str(bw)], check=True)
    shape = (8 * bh, 8 * bw)
    want = native.decode_video([path], shape)[..., 0]
    comps = native.decode_coefs([path])[0]
    np.testing.assert_array_equal(comps[0].coefs.reshape(n, 64), c)
    got = native.idct_islow_u8_ref(
        torch.from_numpy(comps[0].coefs)[None],
        torch.from_numpy(comps[0].qtable)[None], shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("change", ["next", "second_next", "prior", "far",
                                    "dropped"])
def test_wrong_restart_marker_resyncs_as_libjpeg(coef_images, tmp_path,
                                                 change):
    """A colour JPEG with restarts whose fifth RSTn is replaced by the one
    after it, the one after that, the one before it or one four ahead, or
    is dropped: ``jpeg_resync_to_restart``'s actions (leave the marker
    unread and skip to it, scan past it, or swallow it) give the host
    route's decode bitwise through ``decode_video_ref``."""
    full = str(tmp_path / "rst.jpg")
    cv2.imwrite(full, coef_images["scene"], [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    data = bytearray(open(full, "rb").read())
    sos = data.index(b"\xff\xda")
    at = [i for i in range(sos, len(data) - 1)
          if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7][4]
    n = data[at + 1] - 0xD0
    if change == "dropped":
        del data[at:at + 2]
    else:
        step = {"next": 1, "second_next": 2, "prior": 7, "far": 4}[change]
        data[at + 1] = 0xD0 + (n + step) % 8
    path = str(tmp_path / f"{change}.jpg")
    open(path, "wb").write(bytes(data))
    for size in (ODD_SHAPE, (256, 256)):
        np.testing.assert_array_equal(
            native.decode_video_ref([path], size).numpy(),
            native.decode_video([path], size))
