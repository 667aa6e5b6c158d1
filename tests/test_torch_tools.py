"""PyTorch port: the tools, profiling, the folded forward and the
watch-folder evaluator against the JAX package's.

* ``tools/lam_sweep``: the sweep rows and fea_comm statistics of one
  seeded score pickle equal JAX's, and so does the CLI's table;
* ``tools/gen_eval_pins``: ``per_video_pins`` and ``digest_weights``
  equal JAX's; a missing released pickle raises naming its path;
* ``tools/make_toydata``: JPEG frames byte for byte JAX's (cv2 is
  installed here), ``frame_format="npy"`` the same pixels as ``.npy``;
* ``utils/profiling``: ``device_trace`` writes a Chrome trace on the CPU,
  the port's spans in it;
* ``models/folded``: the folded forward equals the port's unfolded one
  and JAX's folded one, at ``tests/test_folded.py``'s bounds;
* ``tools/train_flops``: the generator forward's FLOPs are the analytic
  2 * MACs of its convolutions plus the lookups' formula, beside XLA's
  cost analysis of the JAX forward;
* ``runners/watch_eval``: ``--once --sweep --device cpu`` on a 2-step port
  run (one row, idempotent, ``ValueError`` with the other ``--sweep``),
  and on a JAX run dir, where its AUC equals JAX ``watch_eval``'s;
* ``tools/run_recipe`` for 2 iterations a stage on the CPU (64x64:
  FlowNet2-SD's teacher needs it), and
  ``tools/bench_loader`` on its three backends.
"""

import csv
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_torch.configs import NetConfig
from ammcnet_aaai2021_torch.models import build_generator
from ammcnet_aaai2021_torch.tools.weights import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 32
# the training runs' frames: FlowNet2-SD's six stride-2 levels need 64
TRAIN_SIZE = 64
# UCSD Ped2's test lengths: the built-in ground truth needs no files
PED2_LENGTHS = (180, 180, 150, 180, 150, 180, 180, 180, 120, 150, 180, 180)
RECORD_KEYS = ("rgb_img_pred_records", "rgb_fea_comm_records",
               "op_img_pred_records", "op_fea_comm_records")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A seeded ped2-shaped score pickle (the golden schema)."""
    rng = np.random.default_rng(17)
    rec = {"dataset": "ped2"}
    for key in RECORD_KEYS:
        rec[key] = [rng.normal(30, 3, n).astype(np.float32)
                    for n in PED2_LENGTHS]
    path = str(tmp_path_factory.mktemp("sweep") / "ped2")
    with open(path, "wb") as fh:
        pickle.dump(rec, fh)
    return rec, path


def test_lam_sweep_rows_match_jax(records, tmp_path, capsys):
    from ammcnet_aaai2021_tpu.tools import lam_sweep as jls
    from ammcnet_aaai2021_torch.tools import lam_sweep as ls

    rec, path = records
    items = [("a", path)]
    got = ls.run_sweep(items, str(tmp_path))
    want = jls.run_sweep(items, str(tmp_path))
    assert got == want
    assert ls.fea_comm_stats(rec) == jls.fea_comm_stats(rec)
    ls.main([f"a={path}", "--data_dir", str(tmp_path)])
    out = capsys.readouterr().out
    jls.main([f"a={path}", "--data_dir", str(tmp_path)])
    assert out == capsys.readouterr().out


def test_eval_pins_match_jax(records, tmp_path):
    from ammcnet_aaai2021_tpu.tools import gen_eval_pins as jpins
    from ammcnet_aaai2021_torch.tools import gen_eval_pins as pins

    rec, _ = records
    assert (pins.per_video_pins(rec, (0.01, 0.55))
            == jpins.per_video_pins(rec, (0.01, 0.55)))
    for n, vi in ((1, 0), (180, 3), (5000, 11)):
        np.testing.assert_array_equal(pins.digest_weights(n, vi),
                                      jpins.digest_weights(n, vi))
    missing = os.path.join(str(tmp_path), pins.GOLDEN_LAYOUT.format(d="ped2"))
    with pytest.raises(FileNotFoundError, match=missing):
        pins.main(["--reference_root", str(tmp_path)])


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


TOY = dict(num_train_videos=1, num_test_videos=1, frames_per_video=8,
           image_size=SIZE)


@pytest.mark.parametrize("anomaly", ["teleport", "appearance"])
def test_make_toydata_jpegs_are_jaxs_bytes(tmp_path, anomaly):
    from ammcnet_aaai2021_tpu.tools.make_toydata import make_toydata as j_make
    from ammcnet_aaai2021_torch.tools.make_toydata import make_toydata

    make_toydata(str(tmp_path / "port"), anomaly=anomaly, **TOY)
    j_make(str(tmp_path / "jax"), anomaly=anomaly, **TOY)
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    assert any(name.endswith(".jpg") for name in got)
    assert got == want


def test_make_toydata_npy_writes_the_same_pixels(tmp_path, monkeypatch):
    """The ``npy`` tree holds the RGB arrays the JPEG tree encodes (JAX's
    writes captured as cv2 gets them), and the same flows and GT."""
    import cv2

    from ammcnet_aaai2021_tpu.tools.make_toydata import make_toydata as j_make
    from ammcnet_aaai2021_torch.tools.make_toydata import make_toydata

    written = {}

    def capture(path, img):
        written[path] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return True
    monkeypatch.setattr(cv2, "imwrite", capture)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    j_make(jroot, **TOY)
    make_toydata(proot, frame_format="npy", **TOY)
    got = _files(proot)
    frames = [name for name in got if name.endswith(".npy")]
    assert len(frames) == len(written) == 16
    for name in frames:
        want = written[os.path.join(jroot, name[:-4] + ".jpg")]
        np.testing.assert_array_equal(np.load(os.path.join(proot, name)),
                                      want)
    want_rest = _files(jroot)
    assert {n: b for n, b in got.items() if not n.endswith(".npy")} == \
        want_rest
    with pytest.raises(ValueError, match="frame_format"):
        make_toydata(proot, frame_format="png", **TOY)


def test_device_trace_writes_port_spans(tmp_path):
    import json

    from ammcnet_aaai2021_torch.utils import profiling
    from ammcnet_aaai2021_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path / "trace")) as prof:
        with profiling.span("scorer.forward"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.get("name") == "scorer.forward"
               and e.get("cat") == "user_annotation" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert profiling.summary()["scorer.forward"]["calls"] == 1
    profiling.reset()


# ---------------------------------------------------------------------------
# the folded forward


@pytest.fixture(scope="module")
def weights():
    """JAX-initialized released widths at 64 codewords, in both packages,
    with BatchNorm statistics that are not the init's."""
    from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
    from ammcnet_aaai2021_tpu.models import (
        build_generator as j_build_generator)

    jgen = j_build_generator(JNetConfig(dtype="float32",
                                        use_pallas_memory=False, n_embed=64),
                             per_sample_diff=True)
    variables = jgen.init({"params": jax.random.PRNGKey(0)},
                          jnp.zeros((1, SIZE, SIZE, 12)),
                          jnp.zeros((1, SIZE, SIZE, 6)))
    rng = np.random.default_rng(5)
    variables = jax.tree.map(np.asarray, variables)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                         if "var" in str(path[-1])
                         else rng.normal(0, 0.1, v.shape).astype(np.float32)),
        variables["batch_stats"])
    variables = dict(variables, batch_stats=stats)
    gen = build_generator(NetConfig(dtype="float32", n_embed=64),
                          per_sample_diff=True)
    gen.load_state_dict(state_dict_from_jax(variables))
    return {"variables": variables, "gen": gen.eval()}


def test_folded_matches_unfolded_and_jax(weights):
    from ammcnet_aaai2021_tpu.models.folded import (
        fold_twostream_variables as j_fold, make_folded_forward as j_make)
    from ammcnet_aaai2021_torch.models.folded import make_folded_forward

    rng = np.random.default_rng(3)
    rgb_x = rng.uniform(-1, 1, (2, SIZE, SIZE, 12)).astype(np.float32)
    op_x = rng.uniform(-1, 1, (2, SIZE, SIZE, 6)).astype(np.float32)
    nchw = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
            for x in (rgb_x, op_x)]
    folded = make_folded_forward(weights["gen"].state_dict(), n_embed=64,
                                 dtype=torch.float32, use_kernel=True,
                                 per_sample_diff=True)
    with torch.no_grad():
        ref = weights["gen"](*nchw)
        got = folded(*nchw)
    stacked, bridge = j_fold(weights["variables"])
    jfwd = jax.jit(j_make(n_embed=64, dtype=jnp.float32,
                          per_sample_diff=True))
    j_rgb, j_op, j_diffs = jfwd(stacked, bridge, jnp.asarray(rgb_x),
                                jnp.asarray(op_x))
    jax_out = [np.asarray(j_rgb).transpose(0, 3, 1, 2),
               np.asarray(j_op).transpose(0, 3, 1, 2)]
    for i in range(2):
        for want in (ref[i].numpy(), jax_out[i]):
            np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        for want in (ref[2][i].numpy(), np.asarray(j_diffs[i])):
            np.testing.assert_allclose(got[2][i].numpy(), want, rtol=1e-5,
                                       atol=1e-6)
    assert got[3] is None
    with pytest.raises(RuntimeError, match="inference only"):
        folded.train()(*nchw)


def test_folded_padded_leaves_exact(weights):
    """The op stream's padded taps and outputs are zeros, as JAX's."""
    from ammcnet_aaai2021_tpu.models.folded import (
        fold_twostream_variables as j_fold)
    from ammcnet_aaai2021_torch.models.folded import fold_twostream_variables

    stacked, bridge = fold_twostream_variables(weights["gen"].state_dict())
    inc = stacked["inc.conv.conv.0.weight"]
    assert inc.shape == (2, 64, 12, 3, 3)
    assert torch.equal(inc[1, :, 6:], torch.zeros_like(inc[1, :, 6:]))
    outc = stacked["outc.weight"]
    assert outc.shape == (2, 3, 64, 3, 3)
    assert torch.equal(outc[1, 2:], torch.zeros_like(outc[1, 2:]))
    assert torch.equal(stacked["outc.bias"][1, 2:], torch.zeros(1))
    jstacked, _ = j_fold(weights["variables"])
    np.testing.assert_array_equal(
        inc.permute(0, 3, 4, 2, 1).numpy(),
        np.asarray(jstacked["params"]["inc"]["conv0"]["kernel"]))
    assert set(bridge) == {k[len("bridge."):]
                           for k in weights["gen"].state_dict()
                           if k.startswith("bridge.")}


# ---------------------------------------------------------------------------
# train_flops


def test_train_flops_counts_the_generator_forward(capsys):
    """``FlopCounterMode`` over the generator's forward gives the analytic
    2 * MACs of its convolutions and transposed convolutions plus the two
    lookups' 2 * N * dim * n_embed.  Beside it, XLA's cost analysis of the
    JAX forward at 64x64: lower by 6.5%, because XLA counts only the taps
    that fall inside the image at a SAME-padded border (at the 8x8
    bottleneck a 3x3 tap lands in the padding for 16% of the outputs),
    which outweighs the elementwise work it counts and the counter does
    not."""
    import torch.nn as nn

    from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
    from ammcnet_aaai2021_tpu.models import (
        build_generator as j_build_generator)
    from ammcnet_aaai2021_tpu.tools.train_flops import _flops_of
    from ammcnet_aaai2021_torch.tools.train_flops import census

    size, batch = 64, 2
    c = census(size, batch, "cpu", dtype="float32")
    gen = build_generator(NetConfig(dtype="float32"), per_sample_diff=True)
    macs = []

    def hook(module, inputs, out):
        pixels = (inputs[0] if isinstance(module, nn.ConvTranspose2d)
                  else out)
        macs.append(pixels.shape[0] * pixels.shape[2] * pixels.shape[3]
                    * module.weight.numel())
    for m in gen.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        gen.eval()(torch.zeros(batch, 12, size, size),
                   torch.zeros(batch, 6, size, size))
    rows = batch * (size // 8) ** 2
    lookups = 2 * (2 * rows * 64 * 256)
    assert c["g_forward"] == 2 * sum(macs) + lookups
    assert c["full_step"] > 3 * c["g_forward"]

    jgen = j_build_generator(JNetConfig(use_pallas_memory=False))
    rgb, op = jnp.zeros((batch, size, size, 12)), jnp.zeros((batch, size,
                                                             size, 6))
    variables = jgen.init({"params": jax.random.PRNGKey(0)}, rgb, op)
    xla = _flops_of(lambda v, a, b: jgen.apply(v, a, b, False), variables,
                    rgb, op)
    print(f"generator forward at {size}x{size}, batch {batch}: "
          f"FlopCounterMode {c['g_forward'] / 1e9:.3f} GFLOP, XLA cost "
          f"analysis {xla / 1e9:.3f} GFLOP")
    assert abs(xla - c["g_forward"]) < 0.1 * c["g_forward"]


# ---------------------------------------------------------------------------
# watch_eval, run_recipe, bench_loader


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    from ammcnet_aaai2021_torch.tools.make_toydata import make_toydata

    root = str(tmp_path_factory.mktemp("toy"))
    make_toydata(root, num_train_videos=2, num_test_videos=2,
                 frames_per_video=12, image_size=TRAIN_SIZE)
    return root


def _csv_rows(run_dir):
    with open(os.path.join(run_dir, "watch_results.csv")) as fh:
        return list(csv.reader(fh))


def test_watch_eval_once_sweep_on_a_port_run(toy_root, tmp_path):
    from ammcnet_aaai2021_torch.runners import run_train, watch_eval

    run_dir, _ = run_train.main([
        "--dataset_name", "toydata", "--data_dir", toy_root, "--device",
        "cpu", "--image_size", str(TRAIN_SIZE), "--batch_size", "2",
        "--iterations", "2", "--n_embed", "16", "--step_log", "1",
        "--step_save", "2", "--num_workers", "2",
        "--save_dir", str(tmp_path / "runs"),
        "--registry", str(tmp_path / "runs" / "registry.json")])
    argv = ["--run_dir", run_dir, "--dataset_name", "toydata", "--data_dir",
            toy_root, "--once", "--device", "cpu"]
    step, auc = watch_eval.main(argv + ["--sweep"])
    rows = _csv_rows(run_dir)
    assert rows[0] == watch_eval.results_header(True)
    assert len(rows) == 2 and int(rows[1][0]) == step == 2
    assert float(rows[1][1]) == round(auc, 4)
    assert 0.0 <= auc <= 1.0
    assert watch_eval.main(argv + ["--sweep"]) == (None, -1.0)
    assert len(_csv_rows(run_dir)) == 2
    with pytest.raises(ValueError, match="--sweep"):
        watch_eval.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        watch_eval.main(argv[:-2] + ["--device", "cuda"])


def test_watch_eval_reads_a_jax_run_as_jax_does(toy_root, tmp_path):
    """A JAX run dir (its config, registry entry and an orbax step dir of
    the full train state, as its ``run_train`` writes them, at the init
    state): the port's ``watch_eval`` scores it with the AUC of JAX's
    ``watch_eval`` on a copy of the same dir."""
    import dataclasses

    from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
    from ammcnet_aaai2021_tpu.configs import OptimConfig, preset
    from ammcnet_aaai2021_tpu.models import PixelDiscriminator
    from ammcnet_aaai2021_tpu.models import build_generator as j_build
    from ammcnet_aaai2021_tpu.runners import watch_eval as j_watch
    from ammcnet_aaai2021_tpu.train.checkpoint import save_checkpoint
    from ammcnet_aaai2021_tpu.train.loop import _state_to_pytree
    from ammcnet_aaai2021_tpu.train.optim import make_optimizers
    from ammcnet_aaai2021_tpu.train.state import create_train_state
    from ammcnet_aaai2021_tpu.utils.registry import register_run
    from ammcnet_aaai2021_torch.runners import watch_eval

    net = JNetConfig(dtype="float32", use_pallas_memory=False, n_embed=16,
                     image_size=TRAIN_SIZE)
    cfg = preset("toydata", mode="training", data_dir=toy_root)
    cfg = dataclasses.replace(
        cfg, net=net,
        data=dataclasses.replace(cfg.data, image_size=TRAIN_SIZE),
        save_dir=str(tmp_path / "runs"), exp_tag="jax-run")
    run_dir = register_run(str(tmp_path / "runs" / "registry.json"), cfg)
    g_tx, d_tx = make_optimizers(OptimConfig())
    state = create_train_state(
        j_build(net), PixelDiscriminator(), g_tx, d_tx,
        jax.random.PRNGKey(3), rgb_shape=(2, TRAIN_SIZE, TRAIN_SIZE, 12),
        op_shape=(2, TRAIN_SIZE, TRAIN_SIZE, 6))
    save_checkpoint(os.path.join(run_dir, "training", "checkpoints"), 2,
                    _state_to_pytree(state))
    copy = str(tmp_path / "jax_copy")
    shutil.copytree(run_dir, copy)
    argv = ["--dataset_name", "toydata", "--data_dir", toy_root, "--once"]
    want = j_watch.main(["--run_dir", copy] + argv)
    got = watch_eval.main(["--run_dir", run_dir, "--device", "cpu"] + argv)
    assert got[0] == want[0] == 2
    assert abs(got[1] - want[1]) <= 1e-4
    assert _csv_rows(run_dir)[0] == _csv_rows(copy)[0]


def test_run_recipe_on_the_cpu(tmp_path):
    from ammcnet_aaai2021_torch.tools.run_recipe import main

    root = str(tmp_path / "data")
    out = main(["--data_dir", root, "--save_dir", str(tmp_path / "runs"),
                "--image_size", str(TRAIN_SIZE), "--batch_size", "2",
                "--stage1_iters", "2", "--stage2_iters", "2",
                "--n_embed", "16", "--skip_scratch_control",
                "--anomaly", "teleport", "--frame_format", "npy",
                "--device", "cpu"])
    frames = os.path.join(root, "toydata", "training", "frames", "01")
    assert sorted(os.listdir(frames))[0] == "000.npy"
    assert 0.0 <= out["auc_pretrained"] <= 1.0
    assert set(out["sweep_pretrained"]) == {"psnr_only", "fea_only",
                                            "best_lam", "best_auc"}
    for stage in ("stage1_rgb", "stage1_op"):
        assert os.path.isdir(os.path.join(out[stage], "training",
                                          "checkpoints", "000002"))


def test_bench_loader_backends(toy_root):
    from ammcnet_aaai2021_torch.tools.bench_loader import main

    frames = os.path.join(toy_root, "toydata", "testing", "frames")
    res = main(["--root", frames, "--backends", "normal,native,framepack",
                "--image_size", str(TRAIN_SIZE), "--repeat", "1", "--device",
                "cpu"])
    assert set(res) == {"normal", "native", "framepack"}
    assert all(v > 0 for v in res.values())


@pytest.mark.parametrize("extra", [[], ["--folded"], ["--int8"],
                                   ["--int8", "--calibrated"]])
def test_device_bench_on_the_cpu(extra):
    """The device-resident rate's line at a tiny size on the CPU (the
    same scorer, forwards and timing loop the card runs)."""
    from ammcnet_aaai2021_torch.tools.device_bench import main

    res = main(["--device", "cpu", "--size", str(SIZE), "--frames", "16",
                "--chunk", "1", "--window_batch", "12", "--passes", "2"]
               + extra)
    assert res["metric"] == "device_resident_frames_per_sec"
    want = {"--folded": "folded", "--int8": "int8-dynamic",
            "--calibrated": "int8-calibrated"}
    assert res["forward"] == (want[extra[-1]] if extra else "bfloat16")
    assert res["card"] == "cpu" and len(res["pass_s"]) == 2
    assert res["value"] > 0 and res["windows_per_sec"] > 0


def test_dtype_bench_chains_on_the_cpu():
    """Each level's two chains: cuDNN-shaped bf16 convolutions and the int8
    kernel's op, each output the next one's input."""
    from ammcnet_aaai2021_torch.tools.dtype_bench import (_chain_seconds,
                                                          level_steps)

    steps = level_steps(8, 8, 32, 32, 1, 2, torch.device("cpu"))
    for dtype, (step, x) in steps.items():
        y = step(1, step(0, x))
        assert y.shape == x.shape and y.dtype == x.dtype
        assert _chain_seconds(step, x, 3, torch.device("cpu")) > 0
