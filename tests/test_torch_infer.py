"""PyTorch port: scoring path against JAX, end to end on a numpy toy tree.

* metrics and the record helpers against ``ammcnet_aaai2021_tpu``;
* the port's ``score_dataset`` against the JAX ``score_dataset``
  (``scorer_mode="batch"``, float32, the memory kernel in Pallas interpret
  mode) on one ``.npy`` tree with the same weights: the four record lists to
  1e-4 (float32 convolutions summed in different orders over the whole
  generator) and the same AUC;
* the port's ``run_test`` CLI on the CPU: golden-schema pickle, the
  "the optimal auc =" line, the same AUC as ``evaluate`` on its records;
* both ``run_test`` CLIs on one ``.pth`` and the JAX package's JPEG toydata
  tree, in three flag sets, on a grayscale copy of it with the native
  loader, on-the-fly flow and the gray upload (one FlowNet2-SD ``.pth``),
  and with ``--int8`` on a short tree: the records to 1e-4 of their scale
  and the same printed result line;
* the port and ``chip_smoke.py`` import nothing of JAX.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.eval import infer as jinfer
from ammcnet_aaai2021_tpu.eval.scoring import evaluate as j_evaluate
from ammcnet_aaai2021_tpu.ops import metrics as jmetrics
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_tpu.tools.torch_convert import convert_twostream
from ammcnet_aaai2021_torch.configs import FUSION_LAMBDAS, NetConfig
from ammcnet_aaai2021_torch.eval import infer
from ammcnet_aaai2021_torch.eval.gt import GroundTruthLoader
from ammcnet_aaai2021_torch.eval.scoring import evaluate
from ammcnet_aaai2021_torch.models import build_generator, init_weights
from ammcnet_aaai2021_torch.ops import metrics
from ammcnet_aaai2021_torch.runners import run_test

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = ("rgb_img_pred_records", "rgb_fea_comm_records",
               "op_img_pred_records", "op_fea_comm_records")
SIZE = 64


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", ["psnr", "mse", "ssim"])
def test_per_frame_metrics_match_jax(rng, name):
    gen = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    gt = np.clip(gen + rng.normal(0, 0.1, gen.shape), -1, 1).astype(np.float32)
    want = jmetrics.PER_FRAME_METRICS[name](jnp.asarray(gen), jnp.asarray(gt))
    got = metrics.PER_FRAME_METRICS[name](_nchw(gen), _nchw(gt))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_flow_metrics_match_jax(rng):
    a = rng.normal(size=(3, 8, 8, 2)).astype(np.float32)
    b = rng.normal(size=(3, 8, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(
        metrics.OP_PER_FRAME_METRICS["epe"](_nchw(a), _nchw(b)).numpy(),
        np.asarray(jmetrics.epe_per_frame(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5)
    c = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        metrics.gray_diff(_nchw(c), _nchw(d)).numpy(),
        np.asarray(jmetrics.gray_diff(jnp.asarray(c), jnp.asarray(d))),
        rtol=1e-5, atol=1e-6)


def test_stack_windows_matches_jax(rng):
    video = rng.integers(0, 255, (11, 6, 7, 3), np.uint8)
    idx = np.array([0, 3, 6])
    want = np.asarray(jinfer._stack_windows(jnp.asarray(video),
                                            jnp.asarray(idx), 5))
    got = infer._stack_windows(torch.from_numpy(video), torch.from_numpy(idx), 5)
    assert got.shape == (3, 15, 6, 7) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


def test_op_psnr_reference_bug_matches_jax(rng):
    pred = rng.uniform(-1, 1, (2, 8, 9, 2)).astype(np.float32)
    inp = rng.normal(0, 0.3, (2, 8, 9, 6)).astype(np.float32)
    want = jinfer.op_psnr_reference_bug(jnp.asarray(pred), jnp.asarray(inp))
    got = infer.op_psnr_reference_bug(_nchw(pred), _nchw(inp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_record_helpers_match_jax(rng):
    scores = rng.normal(size=(8,)).astype(np.float32)
    for clip_len, n in ((5, 12), (4, 12)):
        np.testing.assert_array_equal(
            infer._assemble_records(scores, n, clip_len),
            jinfer._assemble_records(scores, n, clip_len))
    np.testing.assert_array_equal(infer.blockwise_mean(scores, 3),
                                  jinfer.blockwise_mean(scores, 3))
    rgb = rng.integers(0, 255, (14, 4, 4, 3), np.uint8)
    op = rng.normal(size=(13, 4, 4, 2)).astype(np.float32)
    for got, want in zip(infer.pad_video_to_bucket(rgb, op, 16),
                         jinfer.pad_video_to_bucket(rgb, op, 16)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_windows,wb", [(8, 4), (9, 4), (3, 192)])
def test_window_batches_cover_each_window_once(n_windows, wb):
    batches = list(infer.window_batches(n_windows, wb))
    assert all(len(s) == min(wb, n_windows) for s, _ in batches)
    seen = np.concatenate([s[:n] for s, n in batches])
    np.testing.assert_array_equal(seen, np.arange(n_windows))


@pytest.fixture(scope="module")
def toy_tree(tmp_path_factory):
    """2 videos x 12 frames of 64x64 u8 .npy frames and float32 .npy flows,
    with toydata.json labels."""
    root = str(tmp_path_factory.mktemp("torch_toy"))
    g = np.random.default_rng(11)
    labels = {}
    for vi, name in enumerate(("01", "02")):
        fdir = os.path.join(root, "toydata", "testing", "frames", name)
        odir = os.path.join(root, "toydata", "testing", "flows", name)
        os.makedirs(fdir)
        os.makedirs(odir)
        for t in range(12):
            np.save(os.path.join(fdir, f"{t:03d}.npy"),
                    g.integers(0, 255, (SIZE, SIZE, 3), np.uint8))
            if t < 11:
                np.save(os.path.join(odir, f"{t:03d}.npy"),
                        g.normal(0, 2, (SIZE, SIZE, 2)).astype(np.float32))
        labels[name] = {"length": 12, "gt": [[3 + vi, 8]]}
    with open(os.path.join(root, "toydata", "toydata.json"), "w") as fh:
        json.dump(labels, fh)
    return root


@pytest.fixture(scope="module")
def scored_pair(toy_tree):
    """The same weights scored by the JAX package and by the port."""
    cfg = NetConfig(dtype="float32", n_embed=32)
    net = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(3)).eval()
    variables = jax.tree.map(jnp.asarray, convert_twostream(
        {k: v.numpy() for k, v in net.state_dict().items()}))
    jgen = j_build_generator(JNetConfig(dtype="float32", n_embed=32),
                             per_sample_diff=True)
    roots = (os.path.join(toy_tree, "toydata", "testing", "frames"),
             os.path.join(toy_tree, "toydata", "testing", "flows"))
    kwargs = dict(batch_size=4, image_size=SIZE, scorer_mode="batch")
    want, _ = jinfer.score_dataset(jgen, variables, *roots, "toydata", **kwargs)
    got, fps = infer.score_dataset(net, *roots, "toydata", **kwargs)
    return want, got, fps


def test_score_dataset_matches_jax(scored_pair):
    want, got, fps = scored_pair
    assert got["dataset"] == "toydata" and fps > 0
    for key in RECORD_KEYS:
        assert [len(r) for r in got[key]] == [12, 12]
        for g, w in zip(got[key], want[key]):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_score_dataset_auc_matches_jax(scored_pair, toy_tree, tmp_path):
    want, got, _ = scored_pair
    gt = GroundTruthLoader(toy_tree)("toydata")
    aucs = []
    for name, result, fn in (("jax", want, j_evaluate),
                             ("torch", got, evaluate)):
        path = tmp_path / name
        with open(path, "wb") as fh:
            pickle.dump(result, fh)
        aucs.append(fn(str(path), lam=FUSION_LAMBDAS["toydata"], gt=gt)["auc"])
    assert aucs[0] == aucs[1]


def test_score_dataset_is_batching_invariant(scored_pair, toy_tree):
    """window_batch changes how many windows share a forward, not a score."""
    _, got, _ = scored_pair
    cfg = NetConfig(dtype="float32", n_embed=32)
    net = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(3)).eval()
    roots = (os.path.join(toy_tree, "toydata", "testing", "frames"),
             os.path.join(toy_tree, "toydata", "testing", "flows"))
    other, _ = infer.score_dataset(net, *roots, "toydata", window_batch=3,
                                   image_size=SIZE, batch_commit=True,
                                   batch_size=4)
    for key in ("rgb_img_pred_records", "op_img_pred_records"):
        for a, b in zip(other[key], got[key]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(other["rgb_fea_comm_records"], got["rgb_fea_comm_records"]):
        # batch_commit: each block of batch_size windows holds its mean
        np.testing.assert_allclose(a[4:8], b[4:8].mean(), rtol=1e-5)


def test_run_test_cli_on_cpu(toy_tree, tmp_path, capsys):
    save = tmp_path / "eval_out"
    res = run_test.main(["--dataset_name", "toydata", "--data_dir", toy_tree,
                         "--save_dir", str(save), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "the optimal auc = " in out and "inference fps = " in out
    pickle_path = save / "img_pred_fea_comm_rgb_auc" / "save_pickle" / "toydata"
    assert res["pickle"] == str(pickle_path)
    with open(pickle_path, "rb") as fh:
        records = pickle.load(fh)
    assert set(records) == {"dataset", *RECORD_KEYS}
    assert all(len(r) == 12 and np.isfinite(r).all()
               for key in RECORD_KEYS for r in records[key])
    gt = GroundTruthLoader(toy_tree)("toydata")
    lam = FUSION_LAMBDAS["toydata"]
    assert res["auc"] == evaluate(str(pickle_path), lam=lam, gt=gt)["auc"]
    assert res["auc"] == j_evaluate(str(pickle_path), lam=lam, gt=gt)["auc"]


def test_run_test_cuda_without_gpu_raises(toy_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_test.main(["--dataset_name", "toydata", "--data_dir", toy_tree,
                       "--save_dir", str(tmp_path)])


@pytest.mark.parametrize("flag", ["--on_the_fly_flow", "--gray_upload",
                                  "--int8", "--native_loader",
                                  "--exp_tag=run1"])
def test_run_test_flags_of_later_slices_raise(toy_tree, tmp_path, flag):
    """No flag is left to a later slice.  The flags ported since behave as
    the JAX CLI's: ``--on_the_fly_flow`` scores with flows made by
    FlowNet2-SD, ``--gray_upload`` alone exits, ``--native_loader`` reads
    JPEG and ``.flo`` files only (this tree is ``.npy``), ``--int8``
    calibrates on the training split, which this tree lacks."""
    argv = ["--dataset_name", "toydata", "--data_dir", toy_tree,
            "--save_dir", str(tmp_path), "--device", "cpu", flag]
    if flag == "--on_the_fly_flow":
        res = run_test.main(argv)
        assert res["flownet_forwards"] == 2 * 4  # 63 pairs a video, 16 a forward
        with open(res["pickle"], "rb") as fh:
            records = pickle.load(fh)
        assert all(len(r) == 12 and np.isfinite(r).all()
                   for key in RECORD_KEYS for r in records[key])
        return
    if flag == "--gray_upload":
        with pytest.raises(SystemExit, match="requires --on_the_fly_flow"):
            run_test.main(argv)
        return
    if flag == "--native_loader":
        with pytest.raises(ValueError, match="JPEG files only"):
            run_test.main(argv)
        return
    if flag == "--int8":
        # as the JAX CLI: the calibration clips come from <data_dir>/
        # toydata/training, which is not there (the CLI parity test below
        # serves --int8 on a tree that has it)
        with pytest.raises(FileNotFoundError, match="training"):
            run_test.main(argv)
        return
    # ported with the training slice: the tag resolves through the run
    # registry (tests/test_torch_train.py scores a registered run), and an
    # unregistered tag raises
    registry = tmp_path / "registry.json"
    registry.write_text("{}")
    with pytest.raises(KeyError, match="run1"):
        run_test.main(argv + ["--registry", str(registry)])


@pytest.fixture(scope="module")
def jpeg_toydata(tmp_path_factory):
    """The JAX package's toydata JPEG tree (2 test videos of 24 frames,
    64x64), a grayscale copy of it (each frame re-encoded by cv2 from its
    luma; no flows directory), a short tree (2 training and 2 test videos
    of 8 frames), one ``.pth`` of the port's seeded init (the
    released configuration, bf16) and one FlowNet2-SD ``.pth`` (the port's
    seeded init)."""
    import shutil

    import cv2

    from ammcnet_aaai2021_tpu.tools.make_toydata import make_toydata
    from ammcnet_aaai2021_torch.models import init_flownet_weights
    from ammcnet_aaai2021_torch.models.flownet_sd import FlowNet2SD

    root = str(tmp_path_factory.mktemp("cli_parity"))
    make_toydata(root, num_train_videos=2, num_test_videos=2,
                 frames_per_video=24, image_size=SIZE)
    gray = os.path.join(root, "gray")
    shutil.copytree(os.path.join(root, "toydata"),
                    os.path.join(gray, "toydata"),
                    ignore=shutil.ignore_patterns("flows"))
    frames = os.path.join(gray, "toydata", "testing", "frames")
    for video in os.listdir(frames):
        for name in os.listdir(os.path.join(frames, video)):
            path = os.path.join(frames, video, name)
            cv2.imwrite(path, cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
    short = str(tmp_path_factory.mktemp("cli_parity_short"))
    make_toydata(short, num_train_videos=2, num_test_videos=2,
                 frames_per_video=8, image_size=SIZE)
    net = init_weights(build_generator(NetConfig()),
                       torch.Generator().manual_seed(3))
    ckpt = os.path.join(root, "generator.pth")
    torch.save(net.state_dict(), ckpt)
    flownet = os.path.join(root, "flownet.pth")
    torch.save(init_flownet_weights(FlowNet2SD(), torch.Generator()
                                    .manual_seed(5)).state_dict(), flownet)
    return {"color": root, "gray": gray, "short": short, "ckpt": ckpt,
            "flownet": flownet}


CLI_FLAG_SETS = {
    "default": [],
    "eer_ssim_epe": ["--eval_type", "compute_eer", "--metric", "ssim",
                     "--op_metric", "epe", "--fix_flow_bug", "--batch_commit"],
    "pr_mse_batch": ["--eval_type", "precision_recall_auc", "--metric", "mse",
                     "--reproduce_op_psnr_bug", "--scorer_mode", "batch",
                     "--batch_size", "5"],
    # on the grayscale tree, with the FlowNet2-SD .pth
    "native_otf_gray": ["--native_loader", "--on_the_fly_flow",
                        "--gray_upload"],
    # on a short tree at 32x32, since XLA:CPU's int8 convolutions are
    # slow: calibrated on 2 training clips, every 3x3 and transposed conv
    # int8, 4 windows a forward
    "int8": ["--int8", "--calib_clips", "2", "--image_size", "32",
             "--scorer_mode", "batch", "--batch_size", "4"],
}


@pytest.mark.parametrize("flags", list(CLI_FLAG_SETS.values()),
                         ids=list(CLI_FLAG_SETS))
def test_run_test_cli_matches_the_jax_cli(jpeg_toydata, tmp_path, capsys,
                                          monkeypatch, flags):
    """Both ``run_test`` CLIs on one checkpoint (``--ckptfile``): the four
    record lists within 1e-4 of their scale (bf16 convolutions of two
    frameworks on the CPU) and the same printed result line.

    With ``--on_the_fly_flow`` both CLIs build FlowNet2-SD in float32 here
    (each CLI builds it in bf16): the op records read the flows directly,
    and two frameworks' bf16 FlowNets, rounding differently through 30
    convolutions, move the op-stream PSNR records by 3e-4 of their scale
    on these weights, past the 1e-4 that holds the generator."""
    import functools

    from ammcnet_aaai2021_tpu.models import flownet_sd as j_flownet_sd
    from ammcnet_aaai2021_tpu.runners import run_test as j_run_test
    from ammcnet_aaai2021_torch.models import flownet_sd

    trees = jpeg_toydata
    root = trees["gray" if "--gray_upload" in flags
                 else "short" if "--int8" in flags else "color"]
    frames = 8 if "--int8" in flags else 24
    if "--on_the_fly_flow" in flags:
        flags = [*flags, "--flownet_ckpt", trees["flownet"]]
        monkeypatch.setattr(j_flownet_sd, "FlowNet2SD", functools.partial(
            j_flownet_sd.FlowNet2SD, dtype=jnp.float32))
        monkeypatch.setattr(flownet_sd, "FlowNet2SD", functools.partial(
            flownet_sd.FlowNet2SD, dtype=torch.float32))
    base = ["--dataset_name", "toydata", "--data_dir", root, "--ckptfile",
            trees["ckpt"], "--image_size", str(SIZE), *flags]

    def result_line(out):
        return [line for line in out.splitlines()
                if line.startswith("the optimal") and "loss_file" not in line]

    results = []
    for name, main, extra in (("jax", j_run_test.main, []),
                              ("torch", run_test.main, ["--device", "cpu"])):
        res = main(base + ["--save_dir", str(tmp_path / name), *extra])
        with open(res["pickle"], "rb") as fh:
            results.append((result_line(capsys.readouterr().out),
                            pickle.load(fh)))
    (jline, want), (tline, got) = results
    assert len(tline) == 1 and tline == jline
    for key in RECORD_KEYS:
        assert [len(r) for r in got[key]] == [frames, frames]
        for g, w in zip(got[key], want[key]):
            # relative to the record's scale; SSIM lies in [-1, 1] and sits
            # near 0 for random weights, so its scale is 1
            scale = 1.0 if key == "rgb_img_pred_records" and "ssim" in flags \
                else float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=key)


def test_port_and_chip_smoke_import_no_jax():
    modules = [
        "ammcnet_aaai2021_torch", "ammcnet_aaai2021_torch.configs",
        "ammcnet_aaai2021_torch.data", "ammcnet_aaai2021_torch.data.datasets",
        "ammcnet_aaai2021_torch.data.flo",
        "ammcnet_aaai2021_torch.data.native",
        "ammcnet_aaai2021_torch.data.framepack",
        "ammcnet_aaai2021_torch.data.resident",
        "ammcnet_aaai2021_torch.eval", "ammcnet_aaai2021_torch.eval.infer",
        "ammcnet_aaai2021_torch.losses", "ammcnet_aaai2021_torch.models",
        "ammcnet_aaai2021_torch.models.quantized",
        "ammcnet_aaai2021_torch.ops.int8_kernels",
        "ammcnet_aaai2021_torch.ops.cuda_build",
        "ammcnet_aaai2021_torch.ops.memory",
        "ammcnet_aaai2021_torch.ops.memory_kernels",
        "ammcnet_aaai2021_torch.ops.metrics",
        "ammcnet_aaai2021_torch.runners.run_test",
        "ammcnet_aaai2021_torch.runners.run_train",
        "ammcnet_aaai2021_torch.tools.weights",
        "ammcnet_aaai2021_torch.train.checkpoint",
        "ammcnet_aaai2021_torch.train.loop",
        "ammcnet_aaai2021_torch.train.optim",
        "ammcnet_aaai2021_torch.train.state",
        "ammcnet_aaai2021_torch.train.steps",
        "ammcnet_aaai2021_torch.utils.logging_utils",
        "ammcnet_aaai2021_torch.utils.registry",
    ]
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'ammcnet_aaai2021_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode != 0 and '"ok"' not in out.stdout
