"""PyTorch port: stage-1 training and the device / framepack backends
against the JAX package.

The same numpy inputs and weights go through the JAX package (float32, its
memory kernels in Pallas interpret mode, as ``tests/test_memory_op.py`` runs
them) and through the port (float32 on the CPU, where the kernels' wrappers
take their plain versions).  Shapes are small: 64x64 frames (the smallest
FlowNetSD takes), batch 2, 32 codewords; the data tests use 32x32 trees.

Tolerances and their reasons (those of ``tests/test_torch_train.py``):

* one stage-1 train step: losses 1e-5 relative; BatchNorm statistics and
  codebooks 1e-5 absolute; gradients 2e-2 per tensor and 5e-3 over the
  generator, relative to their norms (float32 train-mode BatchNorm backward
  loses digits with every level);
* the stage-1 generator's eval forward: 1e-4 (float32 convolutions summed in
  other orders through the whole UNet);
* data: samplers, packs and resident gathers copy values, so they are equal
  (flows after the same bf16 rounding where a backend stores bf16).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from ammcnet_aaai2021_tpu.configs import LossConfig as JLossConfig
from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.data import datasets as jdatasets
from ammcnet_aaai2021_tpu.data import framepack as jframepack
from ammcnet_aaai2021_tpu.data import get_dataset as j_get_dataset
from ammcnet_aaai2021_tpu.models import PixelDiscriminator as JDisc
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_tpu.models.flownet_sd import FlowNet2SD as JFlowNet
from ammcnet_aaai2021_tpu.tools.torch_convert import convert_unetmem_stream
from ammcnet_aaai2021_tpu.train.state import AMMCTrainState
from ammcnet_aaai2021_tpu.train.steps import (
    make_single_stream_train_step as j_make_single_step,
)
from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
from ammcnet_aaai2021_torch.data import datasets, framepack, get_dataset
from ammcnet_aaai2021_torch.data.resident import (
    DeviceResidentSingleStream,
    DeviceResidentTwoStream,
)
from ammcnet_aaai2021_torch.models import (
    FlowNet2SD,
    UNetMemStream,
    build_generator,
    build_model,
    init_weights,
)
from ammcnet_aaai2021_torch.runners import run_train
from ammcnet_aaai2021_torch.tools.weights import (
    discriminator_state_from_jax,
    flownet_state_from_jax,
    single_stream_state_from_jax,
)
from ammcnet_aaai2021_torch.train.checkpoint import latest_step
from ammcnet_aaai2021_torch.train.state import create_train_state
from ammcnet_aaai2021_torch.train.steps import (
    codebook_buffers,
    make_single_stream_train_step,
)

torch.set_num_threads(2)

SIZE, N_EMBED = 64, 32
RECIPES = {"rgb": "rgb_int_gdl_flow_adv_vq", "op": "op_int_adv_vq"}
CH = {"rgb": 3, "op": 2}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _net(data_type, **kw):
    return NetConfig(net_tag="unet_vq_topk_res", data_type=data_type,
                     dtype="float32", n_embed=N_EMBED, **kw)


def _jvars(sd):
    p, s, c = convert_unetmem_stream({k: v.numpy() for k, v in sd.items()})
    return jax.tree.map(jnp.asarray, {"params": p, "batch_stats": s,
                                      "codebook": c})


# ---------------------------------------------------------------------------
# the stage-1 generator and its weight bridge


@pytest.mark.parametrize("data_type", ["rgb", "op"])
def test_build_generator_gives_the_stage1_stream(data_type):
    gen = build_generator(_net(data_type))
    assert isinstance(gen, UNetMemStream)
    assert gen.inc.conv.conv[0].in_channels == {"rgb": 12, "op": 6}[data_type]
    assert gen.outc.out_channels == CH[data_type]
    model = build_model(_net(data_type), "training",
                        with_flow=data_type == "rgb")
    assert model.discriminator.conv0.in_channels == CH[data_type]
    assert (model.flow_network is None) == (data_type == "op")


def test_single_stream_bridge_inverts_the_jax_converter():
    gen = init_weights(build_generator(_net("rgb")),
                       torch.Generator().manual_seed(1))
    sd = gen.state_dict()
    back = single_stream_state_from_jax(jax.tree.map(np.asarray, _jvars(sd)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    UNetMemStream(12, 3, 64, N_EMBED, 2).load_state_dict(back)  # strict


@pytest.mark.parametrize("data_type", ["rgb", "op"])
def test_stage1_forward_matches_jax(rng, data_type):
    """The eval-mode forward (the memory lookup through B1's wrapper)
    against the JAX stage-1 forward (its Pallas kernel, interpret mode)."""
    cfg = _net(data_type)
    gen = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(2)).eval()
    jgen = j_build_generator(
        JNetConfig(net_tag="unet_vq_topk_res", data_type=data_type,
                   dtype="float32", n_embed=N_EMBED, use_pallas_memory=True),
        per_sample_diff=True)
    cin = {"rgb": 12, "op": 6}[data_type]
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, cin)).astype(np.float32)
    want = jgen.apply(_jvars(gen.state_dict()), jnp.asarray(x), False)
    with torch.no_grad():
        got = gen(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for g, w in zip(got, want):
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# one stage-1 step against JAX's make_single_stream_train_step


def _grad_catcher():
    """An optax transformation that applies no update and keeps the
    gradient as its state, so the JAX step returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _stage1_state(data_type, seed=3):
    model = build_model(_net(data_type), "training", with_flow=False)
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # BN statistics and affine away from the init
        for m in state.generator.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.8, 1.2, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
    return state


def _stage1_batch(data_type, seed=0, b=2):
    rng = np.random.default_rng(seed)
    if data_type == "rgb":  # u8, frame-packed: the loaders' layout
        return rng.integers(0, 256, (b, 5, SIZE, SIZE, 3), dtype=np.uint8)
    return rng.normal(0, 0.5, (b, 4, SIZE, SIZE, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def flownet_pair():
    jf = JFlowNet(dtype=jnp.float32)
    variables = jf.init({"params": jax.random.PRNGKey(2)},
                        jnp.zeros((1, SIZE, SIZE, 3, 2)))
    f = FlowNet2SD(dtype=torch.float32).eval()
    f.load_state_dict(flownet_state_from_jax(variables))  # strict
    return jf, variables, f


@pytest.fixture(scope="module", params=["rgb", "op"])
def stage1_pair(request, flownet_pair):
    """One stage-1 step of the JAX package and one of the port from the
    same state and batch: (jax new state, jax metrics, port state, port
    metrics, initial generator state dict, batch, data_type)."""
    data_type = request.param
    loss_tag = RECIPES[data_type]
    jf, flow_vars, flownet = flownet_pair
    if "flow" not in loss_tag:
        flow_vars = flownet = None
    state = _stage1_state(data_type)
    jd = JDisc(dtype=jnp.float32)
    d_params = jd.init({"params": jax.random.PRNGKey(4)},
                       jnp.zeros((1, SIZE, SIZE, CH[data_type])))["params"]
    state.discriminator.load_state_dict(discriminator_state_from_jax(d_params))
    init = copy.deepcopy(state.generator.state_dict())
    jv = _jvars(init)
    tx = _grad_catcher()
    jstate = AMMCTrainState(
        step=jnp.zeros((), jnp.int32), g_params=jv["params"],
        g_state={"batch_stats": jv["batch_stats"], "codebook": jv["codebook"]},
        g_opt_state=tx.init(jv["params"]), d_params=d_params,
        d_opt_state=tx.init(d_params))
    jgen = j_build_generator(JNetConfig(
        net_tag="unet_vq_topk_res", data_type=data_type, dtype="float32",
        n_embed=N_EMBED, use_pallas_memory=True))
    jstep = jax.jit(j_make_single_step(
        jgen, jd, jf, JLossConfig(loss_tag=loss_tag), tx, tx,
        data_type=data_type))
    batch = _stage1_batch(data_type)
    jnew, jmetrics = jstep(jstate, jnp.asarray(batch), flow_vars)
    step = make_single_stream_train_step(LossConfig(loss_tag=loss_tag),
                                         data_type=data_type)
    metrics = step(state, torch.from_numpy(batch), flownet)
    return jnew, jmetrics, state, metrics, init, batch, data_type


def test_stage1_step_losses_match_jax(stage1_pair):
    jnew, jmetrics, state, metrics, *_ = stage1_pair
    assert set(metrics) == set(jmetrics) and state.step == 1
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)


def test_stage1_step_gradients_match_jax(stage1_pair):
    jnew, _, state, *_ = stage1_pair
    grads = {n: p.grad.numpy() for n, p in state.generator.named_parameters()}
    tg = jax.tree_util.tree_leaves_with_path(convert_unetmem_stream(grads)[0])
    jg = jax.tree_util.tree_leaves_with_path(jnew.g_opt_state)
    assert [p for p, _ in tg] == [p for p, _ in jg]
    for (path, a), (_, b) in zip(tg, jg):
        assert _rel(a, b) < 2e-2, jax.tree_util.keystr(path)
    flat = lambda leaves: np.concatenate([np.ravel(x) for _, x in leaves])
    assert _rel(flat(tg), flat(jg)) < 5e-3
    dgrads = {n: p.grad.numpy() for n, p in state.discriminator.named_parameters()}
    for name, leaf in jnew.d_opt_state.items():
        assert _rel(np.transpose(dgrads[f"{name}.weight"], (2, 3, 1, 0)),
                    leaf["kernel"]) < 1e-3, name
        assert _rel(dgrads[f"{name}.bias"], leaf["bias"]) < 1e-3, name


def test_stage1_step_state_matches_jax(stage1_pair):
    """BatchNorm running statistics (flax's biased variance) and the EMA
    codebook after the step (the lookup's statistics from B2's wrapper)."""
    jnew, _, state, *_ = stage1_pair
    _, stats, codebook = convert_unetmem_stream(
        {k: v.numpy() for k, v in state.generator.state_dict().items()})
    for got_tree, col in ((stats, "batch_stats"), (codebook, "codebook")):
        got = jax.tree_util.tree_leaves_with_path(got_tree)
        ref = jax.tree_util.tree_leaves_with_path(jnew.g_state[col])
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (path, a), (_, b) in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_stage1_freeze_codebook_keeps_the_buffers(stage1_pair):
    *_, init, batch, data_type = stage1_pair
    state = _stage1_state(data_type)
    state.generator.load_state_dict(init)
    flownet = FlowNet2SD(dtype=torch.float32).eval() if data_type == "rgb" else None
    step = make_single_stream_train_step(LossConfig(loss_tag=RECIPES[data_type]),
                                         data_type=data_type,
                                         freeze_codebook=True)
    before = {k: v.clone() for k, v in codebook_buffers(state.generator).items()}
    metrics = step(state, torch.from_numpy(batch), flownet)
    assert np.isfinite(metrics["g_loss"].item())
    for k, v in codebook_buffers(state.generator).items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(state.generator.inc.conv.conv[1].running_mean,
                           init["inc.conv.conv.1.running_mean"])


# ---------------------------------------------------------------------------
# data: the single-stream sampler, the resident samplers, framepack, the
# factory


def _write_tree(root, lengths=(12, 10, 9), size=32, seed=11):
    """``<root>/toydata/training/{frames,flows}/NN/``: u8 (size, size, 3)
    frames and float32 (size, size, 2) flows (.npy), one flow fewer than
    frames, videos of different lengths."""
    g = np.random.default_rng(seed)
    for vi, n in enumerate(lengths, start=1):
        fdir = os.path.join(root, "toydata", "training", "frames", f"{vi:02d}")
        odir = os.path.join(root, "toydata", "training", "flows", f"{vi:02d}")
        os.makedirs(fdir)
        os.makedirs(odir)
        for t in range(n):
            np.save(os.path.join(fdir, f"{t:03d}.npy"),
                    g.integers(0, 255, (size, size, 3), np.uint8))
            if t < n - 1:
                np.save(os.path.join(odir, f"{t:03d}.npy"),
                        g.normal(0, 2, (size, size, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stage1_tree"))
    _write_tree(root)
    return tuple(os.path.join(root, "toydata", "training", d)
                 for d in ("frames", "flows"))


@pytest.mark.parametrize("data_type", ["rgb", "op"])
def test_single_stream_sampler_matches_jax(tree, data_type):
    root = tree[0] if data_type == "rgb" else tree[1]
    t = 5 if data_type == "rgb" else 4
    kw = dict(normalize_rgb=False, packed=True)
    want = jdatasets.SingleStreamTrainSampler(
        jdatasets.VideoIndex(root), t,
        jdatasets.ClipLoader(data_type, 32, **kw), seed=13).batch(3)
    mk = lambda: datasets.SingleStreamTrainSampler(
        datasets.VideoIndex(root), t,
        datasets.ClipLoader(data_type, 32, **kw), seed=13)
    got = mk().batch(3)
    assert got.dtype == want.dtype and got.shape == (3, t, 32, 32, CH[data_type])
    np.testing.assert_array_equal(got, want)
    it = datasets.parallel_batches(mk(), 3, num_workers=2)
    par = next(it)
    it.close()
    np.testing.assert_array_equal(par, want)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def test_resident_two_stream_matches_host_sampler(tree):
    """The same (video, offset) draws as the host sampler for a seed, and
    the same pixels: u8 frames exactly, flows after the bf16 store."""
    kw = dict(clip_len_rgb=5, clip_len_op=4, image_size=32, seed=11)
    host = jdatasets.TwoStreamTrainSampler(
        *map(jdatasets.VideoIndex, tree), **kw, normalize_rgb=False,
        packed=True)
    resident = DeviceResidentTwoStream(*map(datasets.VideoIndex, tree), **kw,
                                       device="cpu")
    assert resident.resident_bytes == 3 * 12 * 32 * 32 * 3 + 3 * 11 * 32 * 32 * 2 * 2
    for _ in range(2):
        got, want = resident.batch(4), host.batch(4)
        assert got["rgb"].dtype == torch.uint8 and got["op"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["rgb"].numpy(), want["rgb"])
        assert torch.equal(got["op"], _bf16(want["op"]))
    with pytest.raises(ValueError, match="aligned"):
        DeviceResidentTwoStream(*map(datasets.VideoIndex, tree), aligned=False,
                                device="cpu")


@pytest.mark.parametrize("data_type", ["rgb", "op"])
def test_resident_single_stream_matches_host_sampler(tree, data_type):
    root = tree[0] if data_type == "rgb" else tree[1]
    t = 5 if data_type == "rgb" else 4
    host = jdatasets.SingleStreamTrainSampler(
        jdatasets.VideoIndex(root), t,
        jdatasets.ClipLoader(data_type, 32, normalize_rgb=False, packed=True),
        seed=13)
    resident = DeviceResidentSingleStream(datasets.VideoIndex(root), data_type,
                                          t, image_size=32, seed=13,
                                          device="cpu")
    got, want = resident.batch(3), host.batch(3)
    if data_type == "rgb":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert torch.equal(got, _bf16(want))


def test_resident_sampler_on_a_missing_gpu_raises(tree):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceResidentSingleStream(datasets.VideoIndex(tree[0]), "rgb", 5,
                                   image_size=32, device="cuda")


def test_framepack_roundtrip(tmp_path, rng):
    path = str(tmp_path / "pack.fpk")
    videos = {f"{i:02d}": rng.integers(0, 255, (7 + i, 8, 8, 3), np.uint8)
              for i in range(3)}
    with framepack.FramePackWriter(path, (8, 8, 3), "uint8") as w:
        for name, frames in videos.items():
            w.add_video(name, frames)
    pack = framepack.FramePack(path)
    assert pack.names == sorted(videos)
    for name, frames in videos.items():
        np.testing.assert_array_equal(np.asarray(pack.video(name)), frames)
    clip = pack.clip("01", 2, 4)
    assert clip.shape == (8, 8, 12)
    np.testing.assert_array_equal(clip[..., :3], videos["01"][2])
    with pytest.raises(ValueError):
        framepack.FramePackWriter(str(tmp_path / "x.fpk"), (8, 8, 3)).add_video(
            "a", videos["00"][..., :2])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_framepack_is_one_format(tmp_path, rng, writer):
    """A pack the JAX writer wrote reads in the port, and the other way."""
    path = str(tmp_path / "x.fpk")
    frames = rng.normal(size=(6, 4, 4, 2)).astype(np.float32)
    w_mod, r_mod = ((jframepack, framepack) if writer == "jax"
                    else (framepack, jframepack))
    with w_mod.FramePackWriter(path, (4, 4, 2), "float32") as w:
        w.add_video("v", frames)
    pack = r_mod.FramePack(path)
    assert pack.dtype == np.float32 and pack.length("v") == 6
    np.testing.assert_array_equal(np.asarray(pack.video("v")), frames)
    np.testing.assert_array_equal(pack.clip("v", 1, 3),
                                  jframepack.FramePack(path).clip("v", 1, 3))


@pytest.fixture(scope="module")
def packs(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("packs")
    paths = (str(out / "frames.fpk"), str(out / "flows.fpk"))
    for root, path, dt in zip(tree, paths, ("rgb", "op")):
        framepack.pack_video_tree(root, path, image_size=32, data_type=dt)
    return paths


def test_pack_video_tree_matches_loader_and_jax(tree, packs, tmp_path):
    for root, path, dt in zip(tree, packs, ("rgb", "op")):
        idx = datasets.VideoIndex(root)
        loader = datasets.ClipLoader(dt, 32, normalize_rgb=False, packed=True)
        jpath = str(tmp_path / f"{dt}.fpk")
        jframepack.pack_video_tree(root, jpath, image_size=32, data_type=dt)
        pack = framepack.FramePack(path)
        for name in idx.names:
            want = loader.load_clip(idx.videos[name])
            np.testing.assert_array_equal(np.asarray(pack.video(name)), want)
        with open(path, "rb") as a, open(jpath, "rb") as b:
            assert a.read() == b.read()
        with open(path + ".json") as a, open(jpath + ".json") as b:
            assert json.load(a) == json.load(b)


@pytest.mark.parametrize("normalize", [False, True])
def test_framepack_train_sampler_matches_jax(packs, normalize):
    kw = dict(clip_length=5, seed=3, normalize_rgb=normalize)
    want = jframepack.FramePackTrainSampler(jframepack.FramePack(packs[0]),
                                            **kw).batch(4)
    got = framepack.FramePackTrainSampler(framepack.FramePack(packs[0]),
                                          **kw).batch(4)
    assert got.shape == (4, 32, 32, 15) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_framepack_two_stream_sampler_matches_jax(packs, packed):
    kw = dict(clip_len_rgb=5, clip_len_op=4, seed=13, packed=packed,
              normalize_rgb=not packed)
    want = jframepack.FramePackTwoStreamSampler(
        *map(jframepack.FramePack, packs), **kw).batch(3)
    got = framepack.FramePackTwoStreamSampler(
        *map(framepack.FramePack, packs), **kw).batch(3)
    for k in ("rgb", "op"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_get_dataset_matches_jax(tree, packs):
    assert get_dataset("rgb_op", "testing") is None
    kw = dict(rgb_root=tree[0], op_root=tree[1], image_size=32, seed=5)
    for data_type in ("rgb_op", "rgb", "op"):
        got = get_dataset(data_type, "training", "normal", **kw).batch(2)
        want = j_get_dataset(data_type, "training", "normal", **kw).batch(2)
        if data_type == "rgb_op":
            for k in ("rgb", "op"):
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got.shape == (2, 32, 32, 15 if data_type == "rgb" else 8)
            np.testing.assert_array_equal(got, want)
    fkw = dict(rgb_root=packs[0], op_root=packs[1], seed=5)
    for data_type in ("rgb_op", "rgb", "op"):
        got = get_dataset(data_type, "training", "framepack", **fkw).batch(2)
        want = j_get_dataset(data_type, "training", "framepack", **fkw).batch(2)
        for g, w in ((got[k], want[k]) for k in ("rgb", "op")) if isinstance(
                got, dict) else ((got, want),):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which,mode,match", [
    ("lmdb", "training", "framepack"), ("nope", "training", "which_ds"),
    ("normal", "serving", "mode")])
def test_get_dataset_raises_loudly(which, mode, match):
    with pytest.raises(ValueError, match=match):
        get_dataset("rgb", mode, which, rgb_root="/nonexistent")
    with pytest.raises(ValueError, match=match):
        j_get_dataset("rgb", mode, which, rgb_root="/nonexistent")


# ---------------------------------------------------------------------------
# run_train --device cpu: stage 1 on each backend, --resume, stage 2
# --pretrain from the two stage-1 runs


@pytest.fixture(scope="module")
def runs_root(tmp_path_factory):
    """A 64x64 tree of 2 videos of 8 frames, and its two packs where the
    framepack backend looks for them."""
    root = str(tmp_path_factory.mktemp("stage1_runs"))
    _write_tree(root, lengths=(8, 8), size=SIZE, seed=12)
    base = os.path.join(root, "toydata", "training")
    for name, dt in (("frames", "rgb"), ("flows", "op")):
        framepack.pack_video_tree(os.path.join(base, name),
                                  os.path.join(base, name + ".fpk"),
                                  image_size=SIZE, data_type=dt)
    return root


def _cli(root, tmp, *extra):
    return ["--dataset_name", "toydata", "--data_dir", root, "--device", "cpu",
            "--image_size", str(SIZE), "--batch_size", "2", "--num_workers", "2",
            "--n_embed", str(N_EMBED),
            "--save_dir", os.path.join(tmp, "runs"),
            "--registry", os.path.join(tmp, "runs", "registry.json"),
            "--step_log", "1", "--step_summary", "1", "--step_save", "2",
            *extra]


def _stage1_cli(root, tmp, data_type, *extra):
    return _cli(root, tmp, "--net_tag", "unet_vq_topk_res", "--data_type",
                data_type, "--loss_tag", RECIPES[data_type], *extra)


def _scalars(run_dir):
    with open(os.path.join(run_dir, "summary", "scalars.csv")) as fh:
        rows = [r.split(",") for r in fh.read().splitlines()[1:]]
    return {(int(s), t): float(v) for s, t, v in rows}


@pytest.fixture(scope="module")
def stage1_runs(runs_root, tmp_path_factory):
    """Stage 1 rgb (normal backend, 2 steps) and op (device backend, 2
    steps, then --resume to 3): {data_type: (run_dir, state)}."""
    tmp = str(tmp_path_factory.mktemp("stage1_cli"))
    rgb = run_train.main(_stage1_cli(runs_root, tmp, "rgb", "--iterations", "2",
                                     "--exp_tag", "s1rgb"))
    op = run_train.main(_stage1_cli(runs_root, tmp, "op", "--iterations", "2",
                                    "--backend", "device", "--exp_tag", "s1op"))
    resumed = run_train.main(_stage1_cli(
        runs_root, tmp, "op", "--iterations", "3", "--backend", "device",
        "--resume", "s1op", "--exp_tag", "s1op2"))
    return {"rgb": rgb, "op": op, "op_resumed": resumed, "tmp": tmp}


@pytest.mark.parametrize("data_type", ["rgb", "op"])
def test_run_train_stage1_on_cpu(stage1_runs, data_type):
    run_dir, state = stage1_runs[data_type]
    assert isinstance(state.generator, UNetMemStream) and state.step == 2
    assert latest_step(os.path.join(run_dir, "training", "checkpoints")) == 2
    sc = _scalars(run_dir)
    assert all(np.isfinite(v) for v in sc.values())
    tags = {t for _, t in sc}
    assert {"g_loss", "d_loss", "g_latent_loss", "train_psnr"} <= tags
    assert ("g_flow_loss" in tags) == (data_type == "rgb")
    assert bool(state.generator.vq_down3.quan.quantize.cluster_size.any())
    with open(os.path.join(run_dir, "log_dir", "info.log")) as fh:
        log = fh.read()
    assert ("resident_bytes=" in log) == (data_type == "op")


def test_run_train_stage1_resume(stage1_runs):
    run_dir, state = stage1_runs["op_resumed"]
    assert state.step == 3
    with open(os.path.join(run_dir, "log_dir", "info.log")) as fh:
        log = fh.read()
    assert "resumed full training state from" in log
    assert "training steps 3 to 3" in log


@pytest.mark.parametrize("backend", ["framepack", "device"])
def test_run_train_stage2_pretrained_from_stage1_runs(stage1_runs, runs_root,
                                                      tmp_path, backend):
    """Stage 2 grafts the two stage-1 step dirs (--pretrain) and trains a
    step on the framepack or device backend."""
    (rgb_dir, rgb_state), (op_dir, op_state) = stage1_runs["rgb"], stage1_runs["op"]
    args = _cli(runs_root, str(tmp_path), "--iterations", "1", "--backend",
                backend, "--pretrain",
                "--rgb_model_path", os.path.join(rgb_dir, "training",
                                                 "checkpoints", "000002"),
                "--op_model_path", os.path.join(op_dir, "training",
                                                "checkpoints", "000002"),
                "--freeze_codebook")
    run_dir, state = run_train.main(args)
    assert state.step == 1
    assert all(np.isfinite(v) for v in _scalars(run_dir).values())
    after = state.generator.state_dict()
    for prefix, st in (("rgb", rgb_state), ("op", op_state)):
        # the grafted codebook stays as grafted under --freeze_codebook
        key = "vq_down3.quan.quantize.embed"
        assert torch.equal(after[f"{prefix}.{key}"], st.generator.state_dict()[key])


@pytest.mark.parametrize("extra,error,match", [
    (["--data_type", "rgb", "--net_tag", "unet_vq_topk_res", "--backend",
      "framepack"], ValueError, "stage 2"),
    (["--data_type", "op", "--net_tag", "unet_vq_topk_res", "--pretrain"],
     ValueError, "pretrain"),
    (["--data_type", "rgb"], ValueError, "net_tag"),
    (["--net_tag", "unet_vq_topk_res"], ValueError, "net_tag"),
    (["--backend", "device", "--unaligned_sampling"], ValueError, "aligned"),
])
def test_run_train_rejects_what_no_stage_runs(runs_root, tmp_path, extra,
                                              error, match):
    with pytest.raises(error, match=match):
        run_train.main(_cli(runs_root, str(tmp_path), "--iterations", "1",
                            *extra))
