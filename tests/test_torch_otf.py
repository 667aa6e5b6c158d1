"""PyTorch port: on-the-fly optical flow (``eval/infer.py``
``make_otf_flow_extractor``) and the raw-video inputs of ``score_dataset``.

* The extractor against the JAX package's ``make_otf_flow_extractor`` on
  the same FlowNet2-SD weights (the JAX init carried over by
  ``tools/weights.flownet_state_from_jax``), both in float32, at 64x64 on 9
  frames with ``chunk=4`` (8 pairs: two full chunks, and with ``pad_to=12``
  a ragged third), the reference's flow bug on and off, ``pad_to`` and
  ``gray``: the bf16 flows within 1 bf16 ulp of the largest |flow|
  (2^-8 of it: float32 convolutions of two frameworks, then one bf16
  rounding each), the frames it hands back bitwise.
* The extractor as ``run_test --on_the_fly_flow`` serves it, FlowNet2-SD in
  bf16 in both packages on the same weights, bug on and off: within 4 bf16
  ulps of the largest |flow| of each other, and each as close to the
  float32 flows of those weights as the other (see the test).
* ``score_dataset`` with the extractor: gray and 3-channel uploads give
  bitwise equal records (the broadcast is exact), a colour video under the
  gray extractor raises, and ``op_root`` is never read; on JPEG frames
  through the native loader, a grayscale video whose first frame's channel
  0 the resize rounded off channels 1 and 2 raises where the JAX package
  raises, and otherwise the extractor gets the JAX package's channel 0.
* ``score_dataset(use_native_loader=True)`` on a JPEG + ``.flo`` tree
  against the JAX ``score_dataset`` with its native loader: the records to
  1e-4 (float32 generators of two frameworks, as
  ``tests/test_torch_infer.py`` holds them).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.eval import infer as jinfer
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_tpu.models.flownet_sd import FlowNet2SD as JFlowNet2SD
from ammcnet_aaai2021_tpu.tools.make_toydata import make_toydata
from ammcnet_aaai2021_tpu.tools.torch_convert import convert_twostream
from ammcnet_aaai2021_torch.configs import NetConfig
from ammcnet_aaai2021_torch.eval import infer
from ammcnet_aaai2021_torch.models import build_generator, init_weights
from ammcnet_aaai2021_torch.models.flownet_sd import FlowNet2SD
from ammcnet_aaai2021_torch.tools.weights import flownet_state_from_jax

torch.set_num_threads(2)

SIZE, FRAMES, CHUNK = 64, 9, 4
RECORD_KEYS = ("rgb_img_pred_records", "rgb_fea_comm_records",
               "op_img_pred_records", "op_fea_comm_records")


@pytest.fixture(scope="module")
def flownets():
    """One FlowNet2-SD init in float32, as JAX variables and as the port's
    module."""
    jnet = JFlowNet2SD(dtype=jnp.float32)
    variables = jnet.init({"params": jax.random.PRNGKey(0)},
                          jnp.zeros((1, SIZE, SIZE, 3, 2)))
    net = FlowNet2SD(dtype=torch.float32)
    net.load_state_dict(flownet_state_from_jax(
        jax.tree.map(np.asarray, variables)))
    return jnet, variables, net.eval()


def _video(seed, gray):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    frames = []
    for t in range(FRAMES):  # a blob moving 2 px a frame over texture
        img = (100 + 40 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
               + 80 * np.exp(-((xx - 10 - 2 * t) ** 2 + (yy - 30) ** 2) / 40.0)
               + rng.normal(0, 3, (SIZE, SIZE)))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    v = np.stack(frames)[..., None]
    return v if gray else np.repeat(v, 3, axis=-1)


EXTRACTOR_CASES = {"bug": dict(reproduce_flow_bug=True),
                   "fixed": dict(reproduce_flow_bug=False),
                   "pad_to": dict(reproduce_flow_bug=True, pad_to=12),
                   "gray": dict(reproduce_flow_bug=True, gray=True)}


@pytest.mark.parametrize("case", list(EXTRACTOR_CASES))
def test_extractor_matches_jax(flownets, case):
    jnet, variables, net = flownets
    kwargs = EXTRACTOR_CASES[case]
    video = _video(1, kwargs.get("gray", False))
    want = jinfer.make_otf_flow_extractor(jnet, variables, chunk=CHUNK,
                                          **kwargs)(jnp.asarray(video))
    ex = infer.make_otf_flow_extractor(net, chunk=CHUNK, **kwargs)
    got = ex(torch.from_numpy(video))
    frames = kwargs.get("pad_to", FRAMES)
    assert ex.returns_pair == (case in ("pad_to", "gray"))
    assert ex.forwards == math.ceil((frames - 1) / CHUNK)
    if ex.returns_pair:
        (got_rgb, got), (want_rgb, want) = got, want
        assert got_rgb.shape == (frames, SIZE, SIZE, 3)
        np.testing.assert_array_equal(got_rgb.numpy(), np.asarray(want_rgb))
    assert got.dtype == torch.bfloat16 and got.shape == (frames - 1, SIZE,
                                                         SIZE, 2)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * scale)


# bf16 FlowNets of two frameworks round differently at each layer: at 64x64
# the two extractors' flows were at most 2.9 bf16 ulps of the largest
# |flow| apart, and against the float32 flows of the same weights the port's
# largest error was 0.89-1.20x JAX's and its mean error 0.96-1.02x (seeds
# 1-4, bug on and off: scripts/flownet_bf16_parity.py)
BF16_ULPS, BF16_MAX_RATIO, BF16_MEAN_RATIO = 4, 1.5, 1.25


@pytest.mark.parametrize("bug", [True, False], ids=["bug", "fixed"])
def test_bf16_extractor_matches_jax(flownets, bug):
    jnet32, variables, net32 = flownets
    net = FlowNet2SD()  # bf16, as run_test builds it
    net.load_state_dict(net32.state_dict())
    net.eval()
    video = _video(1, False)
    want = np.asarray(jinfer.make_otf_flow_extractor(
        JFlowNet2SD(dtype=jnp.bfloat16), variables, reproduce_flow_bug=bug,
        chunk=CHUNK)(jnp.asarray(video)), np.float32)
    ex = infer.make_otf_flow_extractor(net, reproduce_flow_bug=bug,
                                       chunk=CHUNK)
    got = ex(torch.from_numpy(video))
    assert got.dtype == torch.bfloat16 and got.shape == (FRAMES - 1, SIZE,
                                                         SIZE, 2)
    got = got.float().numpy()
    f32 = infer.otf_flows(net32, torch.from_numpy(video), bug,
                          CHUNK)[0].numpy()
    scale = float(np.abs(f32).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_ULPS * 2.0 ** -8 * scale)
    err, ref_err = np.abs(got - f32), np.abs(want - f32)
    assert err.max() <= BF16_MAX_RATIO * ref_err.max()
    assert err.mean() <= BF16_MEAN_RATIO * ref_err.mean()


@pytest.fixture(scope="module")
def gray_tree(tmp_path_factory):
    """2 grayscale videos x 12 frames of 64x64 u8 .npy (3 equal channels)
    with toydata.json labels, and no flows directory; and one colour video
    in a second tree."""
    import json

    root = tmp_path_factory.mktemp("otf_gray")
    rng = np.random.default_rng(12)
    for tree, videos, gray in (("gray", ("01", "02"), True),
                               ("color", ("01",), False)):
        labels = {}
        for vi, name in enumerate(videos):
            fdir = root / tree / "toydata" / "testing" / "frames" / name
            os.makedirs(fdir)
            for t in range(12):
                img = rng.integers(0, 256, (SIZE, SIZE, 1 if gray else 3),
                                   np.uint8)
                np.save(fdir / f"{t:03d}.npy", np.repeat(img, 3 // img.shape[2],
                                                        axis=2))
            labels[name] = {"length": 12, "gt": [[3 + vi, 8]]}
        with open(root / tree / "toydata" / "toydata.json", "w") as fh:
            json.dump(labels, fh)
    return root


def _small_generator():
    return init_weights(build_generator(NetConfig(dtype="float32", n_embed=32),
                                        per_sample_diff=True),
                        torch.Generator().manual_seed(3)).eval()


def _score(tree, net, flownet, gray):
    ex = infer.make_otf_flow_extractor(flownet, gray=gray)
    frames = os.path.join(tree, "toydata", "testing", "frames")
    # op_root does not exist: the extractor path never reads it
    result, _ = infer.score_dataset(
        net, frames, os.path.join(tree, "no_flows_here"), "toydata",
        image_size=SIZE, scorer_mode="batch", batch_size=4,
        flow_extractor=ex)
    return result, ex


def test_score_dataset_gray_upload_is_bitwise_the_3_channel_upload(
        gray_tree, flownets):
    net = _small_generator()
    flownet = flownets[2]
    (gray, ex_g), (rgb, ex_c) = (_score(str(gray_tree / "gray"), net, flownet,
                                        g) for g in (True, False))
    # bucket 64: each 12-frame video runs 63 pairs, 4 chunks of 16
    assert ex_g.forwards == ex_c.forwards == 2 * math.ceil(63 / 16)
    for key in RECORD_KEYS:
        assert [len(r) for r in gray[key]] == [12, 12]
        for a, b in zip(gray[key], rgb[key]):
            assert np.isfinite(a).all()
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_score_dataset_gray_extractor_rejects_a_colour_video(gray_tree,
                                                             flownets):
    with pytest.raises(ValueError, match="--gray_upload"):
        _score(str(gray_tree / "color"), _small_generator(), flownets[2],
               True)


def test_score_dataset_native_loader_matches_jax(tmp_path):
    """JPEG frames and .flo flows through both packages' native loaders
    (the same C++ source and flags, so the same frames and flows)."""
    make_toydata(str(tmp_path), num_train_videos=1, num_test_videos=2,
                 frames_per_video=12, image_size=48)
    cfg = NetConfig(dtype="float32", n_embed=32)
    net = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(3)).eval()
    variables = jax.tree.map(jnp.asarray, convert_twostream(
        {k: v.numpy() for k, v in net.state_dict().items()}))
    jgen = j_build_generator(JNetConfig(dtype="float32", n_embed=32),
                             per_sample_diff=True)
    roots = [os.path.join(str(tmp_path), "toydata", "testing", d)
             for d in ("frames", "flows")]
    kwargs = dict(batch_size=4, image_size=SIZE, scorer_mode="batch",
                  use_native_loader=True)
    want, _ = jinfer.score_dataset(jgen, variables, *roots, "toydata",
                                   **kwargs)
    got, _ = infer.score_dataset(net, *roots, "toydata", **kwargs)
    for key in RECORD_KEYS:
        assert [len(r) for r in got[key]] == [12, 12]
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=key)


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_jpeg")
C5_SIZE = 160  # where gray_c5.jpg's channel 0 is off (libjpeg_reference.npz)


class _Handed(Exception):
    """Raised by the recording extractor once it has its input."""


def _recording_extractor():
    """A gray extractor that keeps the (T, h, w, 1) frames it is handed and
    stops the scoring there."""
    def extract(video_u8):
        extract.frames = np.asarray(video_u8)
        raise _Handed

    extract.gray, extract.returns_pair, extract.frames = True, True, None
    return extract


@pytest.mark.parametrize("first", ["c5", "clean"])
def test_gray_upload_of_jpeg_frames_acts_as_the_jax_package(tmp_path, first):
    """Fault C5 under ``--gray_upload``: a grayscale JPEG video decoded by
    the native loader at 160x160.  With ``gray_c5.jpg`` (channel 0 off in
    places) as frame 0 both packages raise "not grayscale"; with a clean
    frame 0 and ``gray_c5.jpg`` as frame 1 both hand their extractor the
    same channel 0, the value that differs included."""
    import shutil

    frames = tmp_path / "toydata" / "testing" / "frames" / "01"
    frames.mkdir(parents=True)
    order = (["gray_c5.jpg", "gray_00.jpg"] if first == "c5"
             else ["gray_00.jpg", "gray_c5.jpg"])
    for t in range(6):
        shutil.copyfile(os.path.join(FIXTURE, order[min(t, 1)]),
                        frames / f"{t:03d}.jpg")
    cfg = NetConfig(dtype="float32", n_embed=32)
    net = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(3)).eval()
    variables = jax.tree.map(jnp.asarray, convert_twostream(
        {k: v.numpy() for k, v in net.state_dict().items()}))
    jgen = j_build_generator(JNetConfig(dtype="float32", n_embed=32),
                             per_sample_diff=True)
    kwargs = dict(image_size=C5_SIZE, scorer_mode="batch", batch_size=4,
                  use_native_loader=True)
    roots = (str(frames.parent), str(tmp_path / "no_flows_here"), "toydata")
    handed = []
    for score in (lambda ex: jinfer.score_dataset(
                      jgen, variables, *roots, flow_extractor=ex, **kwargs),
                  lambda ex: infer.score_dataset(net, *roots,
                                                 flow_extractor=ex,
                                                 **kwargs)):
        ex = _recording_extractor()
        if first == "c5":
            with pytest.raises(ValueError, match="not grayscale"):
                score(ex)
            assert ex.frames is None
        else:
            with pytest.raises(_Handed):
                score(ex)
            handed.append(ex.frames)
    if first == "clean":
        want, got = handed
        assert want.shape[1:] == (C5_SIZE, C5_SIZE, 1)
        np.testing.assert_array_equal(got, want)
        ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
        c5 = ref[f"gray_c5_{C5_SIZE}"][0]
        np.testing.assert_array_equal(want[1, ..., 0], c5[..., 0])
        assert (c5[..., 0] != c5[..., 1]).any()
