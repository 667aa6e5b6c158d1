"""PyTorch port: the native loader (``data/native.py``) against cv2 and the
JAX package's loader.

* ``decode_video`` (host route: the port's copy of the C++ loader, built
  with libjpeg) on grayscale and colour JPEGs written at 240x360 by cv2:
  within 1 LSB of cv2's decode + resize (``_decode_rgb``: cv2 resizes in
  fixed point, the loader in float) and bitwise the JAX package's
  ``native.decode_video`` (the same source and flags);
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
    if jnative.available():  # the JAX loader builds with the same flags
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
    assert size < 1_000_000
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
