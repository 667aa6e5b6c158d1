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
  row); progressive and arithmetic-coded JPEGs raise their named errors;
  the plain IDCT's range limit is jdmaster.c's table and libjpeg's zero-AC
  shortcuts give what its full path gives;
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
from ammcnet_aaai2021_torch.data.flo import write_flo

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
    got = native.load_flow_video(flo_files, size, reproduce_bug=bug)
    want = np.stack([j_load_flow(p, size, bug) for p in flo_files])
    assert got.shape == (4, *size, 2) and got.dtype == np.float32
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


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,size", [((240, 360), (256, 256)),
                                      ((37, 53), (64, 48)),
                                      ((64, 64), (64, 64))])
def test_resize_plain_version_matches_cv2(channels, src, size):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (2, *src, channels), np.uint8)
    got = native.resize_bilinear_u8(torch.from_numpy(img), size).numpy()
    assert got.shape == (2, *size, channels)
    for frame, out in zip(img, got):
        want = cv2.resize(frame, (size[1], size[0])).reshape(out.shape)
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
    bitwise, at an odd size (ragged chroma edges)."""
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
def test_host_route_is_within_1_lsb_of_the_jax_loader(coef_images, tmp_path,
                                                      subsampling, quality):
    """Open fault C4 (``ROADMAP.md``), measured: the port's loaders round
    each of the resize's products and sums (the host library is built with
    ``-ffp-contract=off``, the kernel uses ``__fmul_rn``/``__fadd_rn``);
    the JAX package's loader, built ``-O3 -march=native``, lets g++ fuse
    some of them into FMAs on a CPU that has them.  At source size (no
    resize) the two are bitwise; at 256x256 they may differ by 1 LSB on a
    few values (g++ 13 on an x86-64 CPU with FMA: 0, 2, 1 and 1 of 196,608
    values on these four files)."""
    path = str(tmp_path / "c.jpg")
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{subsampling}")
    cv2.imwrite(path, coef_images["scene"], [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        flag])
    for size in (ODD_SHAPE, (256, 256)):
        port = native.decode_video([path], size).astype(int)
        diff = np.abs(port - jnative.decode_video([path], size))
        if size == ODD_SHAPE:
            assert diff.max() == 0
        else:
            assert diff.max() <= 1 and (diff > 0).sum() <= 8, (
                diff.max(), (diff > 0).sum())


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


@pytest.mark.parametrize("kind", ["gray", "color"])
def test_coef_route_is_the_committed_libjpeg_reference(kind):
    """The fixture's ``libjpeg_reference.npz`` is the host route's decode,
    and the coefficient route gives it bitwise, at source size and at
    256x256 (the card holds its GPU route against the same file)."""
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    count = {"gray": 16, "color": 2}[kind]
    paths = [os.path.join(FIXTURE, f"{kind}_{i:02d}.jpg")
             for i in range(count)]
    for name in ("source", "256"):
        want = ref[f"{kind}_{name}"]
        want = want[..., None] if kind == "gray" else want
        size = want.shape[1:3]
        host = native.decode_video(paths, size)
        np.testing.assert_array_equal(np.broadcast_to(want, host.shape), host)
        got = native.decode_video_ref(paths, size).numpy()
        np.testing.assert_array_equal(got, host)


# libjpeg writing what cv2 cannot ask for: <in.rgb> <w> <h> <out.jpg> <mode>
# with mode "nonint" (4:2:0, one scan per component), "rowrst" (a restart
# marker at the end of every MCU row), "arith" (arithmetic coding)
WRITE_JPEG_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>
int main(int argc, char** argv) {
  int w = atoi(argv[2]), h = atoi(argv[3]);
  unsigned char* rgb = malloc((size_t)w * h * 3);
  FILE* f = fopen(argv[1], "rb");
  if (fread(rgb, 1, (size_t)w * h * 3, f) != (size_t)w * h * 3) return 1;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* o = fopen(argv[4], "wb");
  jpeg_stdio_dest(&c, o);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, 85, TRUE);
  jpeg_scan_info scans[3];
  if (!strcmp(argv[5], "nonint")) {
    for (int i = 0; i < 3; i++) {
      scans[i].comps_in_scan = 1;
      scans[i].component_index[0] = i;
      scans[i].Ss = 0;
      scans[i].Se = 63;
      scans[i].Ah = 0;
      scans[i].Al = 0;
    }
    c.scan_info = scans;
    c.num_scans = 3;
    c.restart_interval = 7;
  } else if (!strcmp(argv[5], "rowrst")) {
    c.restart_in_rows = 1;
  } else {
    c.arith_code = TRUE;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = rgb + (size_t)c.next_scanline * w * 3;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def libjpeg_writer(tmp_path_factory):
    root = tmp_path_factory.mktemp("writer")
    (root / "write_jpeg.c").write_text(WRITE_JPEG_C)
    subprocess.run(["gcc", "-O2", str(root / "write_jpeg.c"), "-o",
                    str(root / "write_jpeg"), "-ljpeg"], check=True)

    def write(img, mode, path):
        raw = path + ".rgb"
        np.ascontiguousarray(img[..., ::-1]).tofile(raw)  # BGR -> RGB
        subprocess.run([str(root / "write_jpeg"), raw, str(img.shape[1]),
                        str(img.shape[0]), path, mode], check=True)
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


def test_coef_route_names_what_it_does_not_take(coef_images, libjpeg_writer,
                                                tmp_path):
    """A progressive and an arithmetic-coded JPEG each raise their own
    error (libjpeg on the host decodes both; the GPU route does not)."""
    prog = str(tmp_path / "p.jpg")
    cv2.imwrite(prog, coef_images["scene"], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    arith = libjpeg_writer(coef_images["scene"], "arith",
                           str(tmp_path / "a.jpg"))
    # the fixture's progressive JPEG, which the card's check feeds its route
    fixture = os.path.join(FIXTURE, "progressive.jpg")
    for path, code in ((prog, 10), (arith, 12), (fixture, 10)):
        with pytest.raises(RuntimeError, match=f"code {code}: "
                           + native.ERRORS[code].split(" (")[0]):
            native.decode_coefs([path])
        assert native.decode_video([path], (64, 64)).shape == (1, 64, 64, 3)
    assert "progressive" in native.ERRORS[10]
    assert "arithmetic" in native.ERRORS[12]


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
    """jdmaster.c prepare_range_limit_table, built as libjpeg builds it,
    indexed as jidctint.c indexes it (``x & RANGE_MASK`` past
    ``CENTERJSAMPLE``)."""
    table = np.zeros(5 * 256 + 128, np.int64)
    base = 256  # table + (MAXJSAMPLE + 1): sample_range_limit
    table[base:base + 256] = np.arange(256)
    idct = base + 128  # the post-IDCT table
    table[idct + 128:idct + 512] = 255
    table[idct + 512:idct + 1024 - 128] = 0
    table[idct + 1024 - 128:idct + 1024] = table[base:base + 128]
    np.testing.assert_array_equal(
        native._range_limit("cpu").numpy(), table[idct:idct + 1024])


def test_plain_idct_zero_ac_shortcuts_give_the_full_path():
    """jidctint.c's shortcuts (pass 1: a column of zero AC terms is its DC
    << PASS1_BITS; pass 2: a row of zero AC terms is range_limit(DESCALE(dc,
    PASS1_BITS + 3))) give what the full path gives, over every DC a valid
    JPEG can hold, with AC terms elsewhere in the block."""
    dc = torch.arange(-2048, 2048, dtype=torch.int16)
    n = dc.numel()
    coefs = torch.zeros((1, 1, n, 64), dtype=torch.int16)
    coefs[0, 0, :, 0] = dc
    # an AC term in column 1 only: columns 0 and 2-7 take pass 1's shortcut
    coefs[0, 0, :, 1] = torch.arange(n, dtype=torch.int16) % 7 - 3
    q = torch.full((1, 64), 1, dtype=torch.uint16)
    got = native.idct_islow_u8_ref(coefs, q, (8, 8 * n))
    # the shortcut of pass 1 on column c != 1 and the full path's
    x = coefs.to(torch.int32).view(1, 1, n, 8, 8)
    full = torch.stack([native._descale(v, 11) for v in
                        native._idct_1d(x.unbind(-2))], dim=-2)
    short = x[..., 0:1, :] * 4  # DC << PASS1_BITS on every row
    cols = [0, 2, 3, 4, 5, 6, 7]
    assert torch.equal(full[..., cols], short.expand_as(full)[..., cols])
    # blocks with a DC alone: every row takes pass 2's shortcut
    flat = coefs.clone()
    flat[..., 1] = 0
    shortcut = native._range_limit("cpu")[
        (native._descale(dc.to(torch.int32) * 4, 5) & 1023).long()]
    plane = native.idct_islow_u8_ref(flat, q, (8, 8 * n))
    assert torch.equal(plane.view(8, n, 8),
                       shortcut.view(1, n, 1).expand(8, n, 8))
    assert got.shape == (1, 8, 8 * n)
