"""PyTorch port: the stage-2 training slice against the JAX package.

The same numpy inputs and weights go through the JAX package (float32, its
training memory kernel B2 in Pallas interpret mode, as
``tests/test_memory_op.py`` runs it) and through the port (float32 on the
CPU, where kernel B2's wrapper takes its plain version).  Shapes are small:
64x64 frames (the smallest FlowNetSD takes), batch 2, 32 codewords.

Tolerances and their reasons:

* lookups gather codewords, so equal indices give equal values; EMA counts
  are integers and must be equal; ``embed_sum`` sums the same float32 values
  in another order: 1e-5 relative to the sum of the magnitudes added into
  each entry;
* single modules and losses: 1e-5 (float32, one or a few convolutions or
  reductions summed in another order);
* one train step: losses 1e-5 relative; BatchNorm statistics and codebooks
  1e-5 absolute; gradients 2e-2 per tensor and 5e-3 over the whole
  generator, relative to their norms.  The gradients are loose because
  float32 train-mode BatchNorm backward subtracts per-channel means of the
  incoming gradient and loses digits with every level: the port in float32
  against itself in float64 differs by up to 3.2e-3 per tensor at these
  shapes, and the difference grows with depth from the loss (1e-6 at the
  output convolution).  Post-Adam parameters are not compared: Adam's first
  step is about lr * sign(g) and would amplify those differences.
* Adam against optax: 1.5e-6 absolute after five updates of at most
  lr = 1e-2 each.  optax takes the bias corrections ``1 - b^t`` in float32,
  where 0.999 rounds so that ``1 - b2`` is off by 1.3e-5 relative, and torch
  in float64: each update may differ by 2e-5 of its size (5 * 1e-2 * 2e-5 =
  1e-6), plus the parameters' own float32 rounding.
"""

import copy
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ammcnet_aaai2021_tpu import configs as jconfigs
from ammcnet_aaai2021_tpu.configs import LossConfig as JLossConfig
from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.configs import OptimConfig as JOptimConfig
from ammcnet_aaai2021_tpu.data import datasets as jdatasets
from ammcnet_aaai2021_tpu.losses import primitives as jprim
from ammcnet_aaai2021_tpu.losses import zoo as jzoo
from ammcnet_aaai2021_tpu.models import PixelDiscriminator as JDisc
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_tpu.models.blocks import DoubleConv as JDoubleConv
from ammcnet_aaai2021_tpu.models.flownet_sd import FlowNet2SD as JFlowNet
from ammcnet_aaai2021_tpu.ops import memory as jmemory
from ammcnet_aaai2021_tpu.ops.memory_pallas import quantize_topk_pallas_train
from ammcnet_aaai2021_tpu.tools.torch_convert import convert_twostream
from ammcnet_aaai2021_tpu.train.optim import make_optimizers as j_make_optimizers
from ammcnet_aaai2021_tpu.train.state import AMMCTrainState
from ammcnet_aaai2021_tpu.train.steps import (
    make_twostream_train_step as j_make_step,
)
from ammcnet_aaai2021_torch import configs
from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
from ammcnet_aaai2021_torch.data import datasets
from ammcnet_aaai2021_torch.losses import primitives as prim
from ammcnet_aaai2021_torch.losses import zoo
from ammcnet_aaai2021_torch.models import (
    BatchNorm2d,
    DoubleConv,
    FlowNet2SD,
    PixelDiscriminator,
    build_model,
)
from ammcnet_aaai2021_torch.ops import memory
from ammcnet_aaai2021_torch.ops.memory_kernels import (
    CUDA_CORE,
    TENSOR_CORE,
    quantize_topk_train_fused,
    quantize_topk_train_fused_ref,
)
from ammcnet_aaai2021_torch.runners import run_test, run_train
from ammcnet_aaai2021_torch.tools.weights import (
    discriminator_state_from_jax,
    flownet_state_from_jax,
    load_generator_checkpoint,
)
from ammcnet_aaai2021_torch.train.checkpoint import (
    latest_step,
    load_state_file,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from ammcnet_aaai2021_torch.train.optim import make_optimizers
from ammcnet_aaai2021_torch.train.state import create_train_state, graft_branches
from ammcnet_aaai2021_torch.train.steps import (
    codebook_buffers,
    make_twostream_train_step,
)
from ammcnet_aaai2021_torch.utils import registry

torch.set_num_threads(2)

SIZE, N_EMBED, DIM, K = 64, 32, 64, 2


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


# ---------------------------------------------------------------------------
# kernel B2's plain version and the memory op in training


@pytest.mark.parametrize("case", ["f32", "bf16", "ragged", "dup"])
def test_train_kernel_plain_version_matches_pallas(case):
    n = {"ragged": 600, "f32": 128, "bf16": 128, "dup": 96}[case]
    rng = np.random.default_rng(0)
    flat = rng.normal(size=(n, DIM)).astype(np.float32)
    embed = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    if case == "dup":  # columns 2m and 2m+1 equal: ties in pairs
        embed[:, 1::2] = embed[:, 0::2]
    dtype = "bfloat16" if case == "bf16" else "float32"
    jq, jq1, jidx, jcounts, jesum = quantize_topk_pallas_train(
        jnp.asarray(flat).astype(dtype), jnp.asarray(embed), K)
    tflat = torch.from_numpy(flat).to(getattr(torch, dtype))
    q, q1, idx, counts, esum = quantize_topk_train_fused_ref(
        tflat, torch.from_numpy(embed), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q1.numpy(), np.asarray(jq1))
    if case == "dup":
        assert (idx.numpy() % 2 == 0).all()
    # counts: integers, exact; the zero pad rows of the JAX wrapper (ragged
    # 600 -> 1024) are subtracted there and never counted here
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.sum() == n
    # embed_sum: within 1e-5 of the magnitude summed into each entry
    onehot = np.eye(N_EMBED, dtype=np.float64)[idx.numpy()]
    mag = np.abs(tflat.double().numpy()).T @ onehot
    assert np.all(np.abs(esum.numpy() - np.asarray(jesum)) <= 1e-5 * mag + 1e-30)


def test_train_wrapper_on_cpu_takes_plain_version_without_counting():
    rng = np.random.default_rng(1)
    flat = torch.from_numpy(rng.normal(size=(50, DIM)).astype(np.float32))
    embed = torch.from_numpy(rng.normal(size=(DIM, N_EMBED)).astype(np.float32))
    before = quantize_topk_train_fused.launches
    got = quantize_topk_train_fused(flat, embed, K)
    want = quantize_topk_train_fused_ref(flat, embed, K)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert quantize_topk_train_fused.launches == before
    with pytest.raises(ValueError):
        quantize_topk_train_fused(flat.to(torch.float16), embed, K)


def test_train_wrapper_rejects_a_tensor_core_route_the_rule_does_not_give():
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.normal(size=(24, DIM)).astype(np.float32))
    embed = torch.from_numpy(rng.normal(size=(DIM, N_EMBED)).astype(np.float32))
    with pytest.raises(ValueError, match="route"):
        quantize_topk_train_fused(flat, embed, K, route=TENSOR_CORE)  # f32
    bf16 = flat.to(torch.bfloat16)
    want = quantize_topk_train_fused_ref(bf16, embed, K)
    for route in (TENSOR_CORE, CUDA_CORE):  # the CPU takes the plain version
        got = quantize_topk_train_fused(bf16, embed, K, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ema_apply_matches_jax():
    rng = np.random.default_rng(2)
    embed = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    cs = rng.uniform(0, 5, N_EMBED).astype(np.float32)
    avg = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    counts = rng.integers(0, 9, N_EMBED).astype(np.float32)
    esum = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    want = jmemory.ema_apply(jmemory.Codebook(*map(jnp.asarray, (embed, cs, avg))),
                             jnp.asarray(counts), jnp.asarray(esum))
    got = memory.ema_apply(memory.Codebook(*map(torch.from_numpy, (embed, cs, avg))),
                           torch.from_numpy(counts), torch.from_numpy(esum))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="multi-process"):
        memory.ema_apply(got, torch.from_numpy(counts), torch.from_numpy(esum),
                         axis_name="data")


@pytest.mark.parametrize("st_mode", ["top1", "topk"])
@pytest.mark.parametrize("fused", [False, True])
def test_quantize_topk_train_matches_jax(fused, st_mode):
    """Lookup, commit distance, the EMA-updated codebook and the commit
    distance's gradient to z (the only gradient of the op) against JAX, on a
    ragged row count (2*5*7 = 70)."""
    rng = np.random.default_rng(3)
    z = rng.normal(size=(2, 5, 7, DIM)).astype(np.float32)
    embed = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    cs = rng.uniform(0, 3, N_EMBED).astype(np.float32)
    jcb = jmemory.Codebook(jnp.asarray(embed), jnp.asarray(cs), jnp.asarray(embed))

    def jloss(zz):
        q, diff, q_st, cb = jmemory.quantize_topk(
            zz, jcb, K, train=True, use_pallas=fused, st_mode=st_mode)
        return diff, (q, q_st, cb)

    (jdiff, (jq, jst, jnew)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_(True)
    tcb = memory.Codebook(torch.from_numpy(embed), torch.from_numpy(cs),
                          torch.from_numpy(embed))
    tq, tdiff, tst, tnew = memory.quantize_topk(
        tz, tcb, K, train=True, use_kernel=fused, st_mode=st_mode)
    tdiff.backward()
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tst.detach().numpy(), np.asarray(jst), atol=1e-5)
    np.testing.assert_allclose(tdiff.item(), float(jdiff), rtol=1e-5)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(tnew.cluster_size.numpy(),
                                  np.asarray(jnew.cluster_size))
    for name in ("embed", "embed_avg"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(jnew, name)),
                                   rtol=1e-5, atol=1e-6)
    # the given codebook is left as it was
    assert torch.equal(tcb.embed, torch.from_numpy(embed))


# ---------------------------------------------------------------------------
# modules


def test_batchnorm_training_statistics_match_flax(rng):
    """Trap: torch's BatchNorm2d updates running_var with the unbiased batch
    variance, flax (and the port) with the biased one."""
    x = rng.normal(1.0, 2.0, size=(2, 4, 4, 3)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jy, jstate = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm2d(3).train()
    ty = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(jstate["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(jstate["batch_stats"]["var"]),
                               rtol=1e-6)
    plain = torch.nn.BatchNorm2d(3).train()
    plain(_nchw(x))
    n = x.size // 3
    var_t = (plain.running_var.numpy() - 0.9) / 0.1
    var_f = (port.running_var.numpy() - 0.9) / 0.1
    np.testing.assert_allclose(var_t / var_f, n / (n - 1), rtol=1e-4)


def test_double_conv_training_forward_and_statistics_match_jax(rng):
    from ammcnet_aaai2021_torch.tools.weights import double_conv_state

    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    jmod = JDoubleConv(8, dtype=jnp.float32)
    v = jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    jy, jstate = jmod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    mod = DoubleConv(5, 8).train()
    mod.load_state_dict({k[2:]: t for k, t in double_conv_state(
        "m", v["params"], v["batch_stats"]).items()})
    ty = mod(_nchw(x))
    np.testing.assert_allclose(_nhwc(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for i, bn in ((1, "bn0"), (4, "bn1")):
        np.testing.assert_allclose(mod.conv[i].running_var.numpy(),
                                   np.asarray(jstate["batch_stats"][bn]["var"]),
                                   rtol=1e-5)


def test_discriminator_matches_jax(rng):
    x = rng.uniform(-1, 1, size=(2, SIZE, SIZE, 3)).astype(np.float32)
    jd = JDisc(dtype=jnp.float32)
    params = jd.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))["params"]
    d = PixelDiscriminator(dtype=torch.float32)
    d.load_state_dict(discriminator_state_from_jax(params))  # strict
    assert [n for n, _ in d.named_children()] == ["conv0", "conv1", "conv2", "out"]
    got = d(_nchw(x))
    want = jd.apply({"params": params}, jnp.asarray(x))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 10, 10)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def flownet_pair():
    jf = JFlowNet(dtype=jnp.float32)
    variables = jf.init({"params": jax.random.PRNGKey(2)},
                        jnp.zeros((1, SIZE, SIZE, 3, 2)))
    f = FlowNet2SD(dtype=torch.float32).eval()
    f.load_state_dict(flownet_state_from_jax(variables))  # strict
    return jf, variables, f


def test_flownet_matches_jax(rng, flownet_pair):
    jf, variables, f = flownet_pair
    frames = rng.uniform(0, 255, size=(2, SIZE, SIZE, 3, 2)).astype(np.float32)
    want = jf.apply(variables, jnp.asarray(frames))
    with torch.no_grad():
        got = f(torch.from_numpy(np.ascontiguousarray(
            frames.transpose(0, 3, 4, 1, 2))))
    assert got.shape == (2, 2, SIZE, SIZE)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# losses


def _loss_batch(seed):
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    return {"rgb_pred": u(2, 8, 8, 3), "rgb_target": u(2, 8, 8, 3),
            "op_pred": u(2, 8, 8, 2), "op_target": u(2, 8, 8, 2),
            "d_gen": u(2, 3, 3, 1), "flow_pred": u(2, 8, 8, 2),
            "flow_gt": u(2, 8, 8, 2)}


@pytest.mark.parametrize("name", ["flow", "int1", "int2", "gdl", "gdl2",
                                  "adv", "disc"])
def test_loss_primitives_match_jax(name):
    b = _loss_batch(4)
    p, t = b["rgb_pred"], b["rgb_target"]
    jfn, tfn, args = {
        "flow": (jprim.flow_loss, prim.flow_loss, (p, t)),
        "int1": (lambda a, c: jprim.intensity_loss(a, c, 1),
                 lambda a, c: prim.intensity_loss(a, c, 1), (p, t)),
        "int2": (jprim.intensity_loss, prim.intensity_loss, (p, t)),
        "gdl": (jprim.gradient_loss, prim.gradient_loss, (p, t)),
        "gdl2": (lambda a, c: jprim.gradient_loss(a, c, 2),
                 lambda a, c: prim.gradient_loss(a, c, 2), (p, t)),
        "adv": (jprim.adversarial_loss, prim.adversarial_loss, (b["d_gen"],)),
        "disc": (jprim.discriminate_loss, prim.discriminate_loss,
                 (b["d_gen"], b["d_gen"][::-1])),
    }[name]
    want = float(jfn(*map(jnp.asarray, args)))
    got = tfn(*(_nchw(a) for a in args))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("tag", sorted(jzoo.LOSS_TAGS))
def test_loss_zoo_tags_match_jax(tag):
    b = _loss_batch(5)
    w = jconfigs.train_loss_preset("ped2", tag)
    diffs = (np.float32(0.3), np.float32(0.7))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["latent_diff"] = tuple(jnp.asarray(d) for d in diffs)
    tb = {k: _nchw(v) for k, v in b.items()}
    tb["latent_diff"] = tuple(torch.tensor(d) for d in diffs)
    jg, jc = jzoo.LOSS_TAGS[tag](jb, w)
    g_fn, d_fn = zoo.get_loss(tag)
    tg, tc = g_fn(tb, configs.train_loss_preset("ped2", tag))
    assert d_fn is prim.discriminate_loss and set(tc) == set(jc)
    np.testing.assert_allclose(tg.item(), float(jg), rtol=1e-5)
    for k in jc:
        np.testing.assert_allclose(tc[k].item(), float(jc[k]), rtol=1e-5)
    with pytest.raises(ValueError):
        zoo.get_loss("no_such_tag")


def test_configs_match_jax(tmp_path):
    for ds in ("ped2", "avenue", "shanghaitech", "toydata"):
        for tag in jzoo.LOSS_TAGS:
            for bug in (True, False):
                assert (configs.train_loss_preset(ds, tag, bug).__dict__
                        == jconfigs.train_loss_preset(ds, tag, bug).__dict__)
    assert configs.DISC_FILTERS == jconfigs.DISC_FILTERS
    assert (configs.STEP_LOG, configs.STEP_SUMMARY, configs.STEP_SAVE_CKPT) == (
        jconfigs.STEP_LOG, jconfigs.STEP_SUMMARY, jconfigs.STEP_SAVE_CKPT)
    assert OptimConfig().__dict__ == JOptimConfig().__dict__
    cfg = configs.preset("ped2", data_dir="/d")
    assert configs.ExperimentConfig.from_json(cfg.to_json()) == cfg
    # a config the JAX package wrote loads (its extra sections are ignored)
    back = configs.ExperimentConfig.from_json(
        jconfigs.preset("ped2", data_dir="/d").to_json())
    assert back.net.n_embed == 256 and back.loss == cfg.loss
    run_dir = registry.register_run(str(tmp_path / "reg.json"), configs.ExperimentConfig(
        save_dir=str(tmp_path), exp_tag="e1"))
    assert registry.resolve_run(str(tmp_path / "reg.json"), "e1") == run_dir
    assert registry.load_run_config(run_dir).exp_tag == "e1"
    with pytest.raises(KeyError):
        registry.resolve_run(str(tmp_path / "reg.json"), "e2")


# ---------------------------------------------------------------------------
# optimizer


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for name in ("rgb", "op", "bridge"):
            self.add_module(name, torch.nn.Linear(3, 2))


@pytest.mark.parametrize("fix_branches", [False, True])
def test_adam_and_schedule_match_optax(fix_branches):
    """Five updates with a milestone at 2 (updates 3.. run at half rate)."""
    cfg = OptimConfig(lr_g=1e-2, lr_d=1e-3, lr_milestones=(2,))
    gen, disc = _Tiny(), torch.nn.Linear(2, 1)
    mask = ({k: k == "bridge" for k in ("rgb", "op", "bridge")}
            if fix_branches else None)
    g_opt, _, g_sched, _ = make_optimizers(cfg, gen, disc, mask)
    jcfg = JOptimConfig(lr_g=1e-2, lr_d=1e-3, lr_milestones=(2,))
    j_tx, _ = j_make_optimizers(jcfg, mask)
    params = {n: p.detach().numpy().copy() for n, p in gen.named_parameters()}
    jparams = {k: {n.split(".")[1]: jnp.asarray(v) for n, v in params.items()
                   if n.startswith(k + ".")} for k in ("rgb", "op", "bridge")}
    jstate = j_tx.init(jparams)
    rng = np.random.default_rng(6)
    for _ in range(5):
        grads = {n: rng.normal(size=v.shape).astype(np.float32)
                 for n, v in params.items()}
        for n, p in gen.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        g_opt.step()
        g_sched.step()
        jg = {k: {n.split(".")[1]: jnp.asarray(v) for n, v in grads.items()
                  if n.startswith(k + ".")} for k in jparams}
        upd, jstate = j_tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for n, p in gen.named_parameters():
        k, leaf = n.split(".")
        want = np.asarray(jparams[k][leaf])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1.5e-6)
        if fix_branches and k != "bridge":
            np.testing.assert_array_equal(p.detach().numpy(), params[n])
    assert g_sched.get_last_lr() == [5e-3]


# ---------------------------------------------------------------------------
# one train step against JAX's make_twostream_train_step


def _grad_catcher():
    """An optax transformation that applies no update and keeps the
    gradient as its state, so the JAX step returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port_train_setup(seed=3, n_embed=N_EMBED):
    model = build_model(NetConfig(dtype="float32", n_embed=n_embed), "training")
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
    return model, state


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 256, (b, 5, SIZE, SIZE, 3), dtype=np.uint8),
            "op": rng.normal(0, 0.5, (b, 4, SIZE, SIZE, 2)).astype(np.float32)}


@pytest.fixture(scope="module")
def step_pair(flownet_pair):
    """One step of the JAX package and one of the port from the same state
    and batch: (jax new state, jax metrics, port state, port metrics,
    initial port state dict, batch, flownet)."""
    jf, flow_vars, flownet = flownet_pair
    model, state = _port_train_setup()
    jd = JDisc(dtype=jnp.float32)
    d_params = jd.init({"params": jax.random.PRNGKey(4)},
                       jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    state.discriminator.load_state_dict(discriminator_state_from_jax(d_params))
    init = copy.deepcopy(state.generator.state_dict())
    jv = jax.tree.map(jnp.asarray, convert_twostream(
        {k: v.numpy() for k, v in init.items()}))
    tx = _grad_catcher()
    jstate = AMMCTrainState(
        step=jnp.zeros((), jnp.int32), g_params=jv["params"],
        g_state={"batch_stats": jv["batch_stats"], "codebook": jv["codebook"]},
        g_opt_state=tx.init(jv["params"]), d_params=d_params,
        d_opt_state=tx.init(d_params))
    jgen = j_build_generator(JNetConfig(dtype="float32", n_embed=N_EMBED,
                                        use_pallas_memory=True))
    jstep = jax.jit(j_make_step(jgen, jd, jf, JLossConfig(), tx, tx))
    batch = _batch()
    jnew, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           flow_vars)
    step = make_twostream_train_step(LossConfig())
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                   flownet)
    return jnew, jmetrics, state, metrics, init, batch, flownet


def test_train_step_losses_match_jax(step_pair):
    jnew, jmetrics, state, metrics, *_ = step_pair
    assert set(metrics) == set(jmetrics) and state.step == 1
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)


def test_train_step_gradients_match_jax(step_pair):
    jnew, _, state, *_ = step_pair
    grads = {n: p.grad.numpy() for n, p in state.generator.named_parameters()}
    tg = jax.tree_util.tree_leaves_with_path(convert_twostream(grads)["params"])
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


def test_train_step_state_matches_jax(step_pair):
    """BatchNorm running statistics (flax's biased variance) and the EMA
    codebooks after the step."""
    jnew, _, state, *_ = step_pair
    sd = {k: v.numpy() for k, v in state.generator.state_dict().items()}
    want = convert_twostream(sd)
    for col in ("batch_stats", "codebook"):
        got = jax.tree_util.tree_leaves_with_path(want[col])
        ref = jax.tree_util.tree_leaves_with_path(jnew.g_state[col])
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (path, a), (_, b) in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_freeze_codebook_keeps_buffers_and_gradients(step_pair):
    _, _, state, metrics, init, batch, flownet = step_pair
    model, frozen = _port_train_setup()
    frozen.generator.load_state_dict(init)
    frozen.discriminator.load_state_dict(state.discriminator.state_dict())
    # the discriminator above has already stepped once: compare G only
    step = make_twostream_train_step(LossConfig(), freeze_codebook=True)
    before = {k: v.clone() for k, v in codebook_buffers(frozen.generator).items()}
    step(frozen, {k: torch.from_numpy(v) for k, v in batch.items()}, flownet)
    for k, v in codebook_buffers(frozen.generator).items():
        assert torch.equal(v, before[k]), k
    bn = frozen.generator.rgb.inc.conv.conv[1]
    assert not torch.equal(bn.running_mean, init["rgb.inc.conv.conv.1.running_mean"])
    with pytest.raises(NotImplementedError, match="twice"):
        make_twostream_train_step(LossConfig(), remat=True)


def test_fix_branches_trains_only_the_bridge(step_pair):
    *_, init, batch, flownet = step_pair
    model, state = _port_train_setup()
    mask = {k: k == "bridge" for k in ("rgb", "op", "bridge")}
    state.g_opt, state.d_opt, state.g_sched, state.d_sched = make_optimizers(
        OptimConfig(), state.generator, state.discriminator, mask)
    before = copy.deepcopy(state.generator.state_dict())
    make_twostream_train_step(LossConfig())(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, flownet)
    after = state.generator.state_dict()
    for name, _ in state.generator.named_parameters():
        same = torch.equal(after[name], before[name])
        assert same == (not name.startswith("bridge.")), name
    # BatchNorm statistics and the codebook stay live, as in the JAX step
    assert not torch.equal(after["rgb.inc.conv.conv.1.running_mean"],
                           before["rgb.inc.conv.conv.1.running_mean"])
    assert not torch.equal(after["op.vq_down3.quan.quantize.cluster_size"],
                           before["op.vq_down3.quan.quantize.cluster_size"])


def test_graft_branches_mounts_stage1_state():
    model, state = _port_train_setup()
    sd = state.generator.state_dict()
    rgb = {k[4:]: torch.randn_like(v.float()).to(v.dtype)
           for k, v in sd.items() if k.startswith("rgb.")}
    op = {k[3:]: v.clone() for k, v in sd.items() if k.startswith("op.")}
    bridge = {k: v.clone() for k, v in sd.items() if k.startswith("bridge.")}
    graft_branches(state.generator, rgb, op)
    after = state.generator.state_dict()
    assert all(torch.equal(after[f"rgb.{k}"], v) for k, v in rgb.items())
    assert all(torch.equal(after[k], v) for k, v in bridge.items())
    del rgb["vq_down3.quan.quantize.embed"]
    with pytest.raises(KeyError, match="missing"):
        graft_branches(state.generator, rgb, op)


# ---------------------------------------------------------------------------
# data, loop, checkpoint, CLI


def _write_training_tree(root, videos=2, frames=12, seed=11):
    g = np.random.default_rng(seed)
    for vi in range(1, videos + 1):
        fdir = os.path.join(root, "toydata", "training", "frames", f"{vi:02d}")
        odir = os.path.join(root, "toydata", "training", "flows", f"{vi:02d}")
        os.makedirs(fdir)
        os.makedirs(odir)
        for t in range(frames):
            np.save(os.path.join(fdir, f"{t:03d}.npy"),
                    g.integers(0, 255, (SIZE, SIZE, 3), np.uint8))
            if t < frames - 1:
                np.save(os.path.join(odir, f"{t:03d}.npy"),
                        g.normal(0, 2, (SIZE, SIZE, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train"))
    _write_training_tree(root)
    return root


@pytest.mark.parametrize("aligned", [True, False])
def test_train_sampler_matches_jax(train_tree, aligned):
    roots = [os.path.join(train_tree, "toydata", "training", d)
             for d in ("frames", "flows")]
    kw = dict(aligned=aligned, image_size=SIZE, normalize_rgb=False,
              packed=True, seed=5)
    want = jdatasets.TwoStreamTrainSampler(
        *map(jdatasets.VideoIndex, roots), **kw).batch(3)
    sampler = datasets.TwoStreamTrainSampler(*map(datasets.VideoIndex, roots), **kw)
    got = sampler.batch(3)
    for k in ("rgb", "op"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = datasets.parallel_batches(datasets.TwoStreamTrainSampler(
        *map(datasets.VideoIndex, roots), **kw), 3, num_workers=2)
    par = next(it)
    it.close()
    np.testing.assert_array_equal(par["rgb"], got["rgb"])


def _cli(root, tmp, *extra):
    return ["--dataset_name", "toydata", "--data_dir", root, "--device", "cpu",
            "--image_size", str(SIZE), "--batch_size", "2", "--num_workers", "2",
            "--save_dir", os.path.join(tmp, "runs"),
            "--registry", os.path.join(tmp, "runs", "registry.json"),
            "--step_log", "2", "--step_summary", "2", "--step_save", "2",
            *extra]


@pytest.fixture(scope="module")
def trained_run(train_tree, tmp_path_factory):
    """``run_train`` on the CPU for 2 steps, then ``--resume`` to step 3."""
    tmp = str(tmp_path_factory.mktemp("torch_runs"))
    run_dir, state = run_train.main(_cli(train_tree, tmp, "--iterations", "2",
                                         "--exp_tag", "toy"))
    saved = copy.deepcopy(state.generator.state_dict())
    opt = copy.deepcopy(state.g_opt.state_dict())
    run2, state2 = run_train.main(_cli(train_tree, tmp, "--iterations", "3",
                                       "--resume", "toy", "--exp_tag", "toy2",
                                       "--keep_ckpts", "1"))
    return tmp, run_dir, saved, opt, run2, state2


def test_run_train_cli_on_cpu(trained_run):
    tmp, run_dir, saved, *_ = trained_run
    ckpt_dir = os.path.join(run_dir, "training", "checkpoints")
    assert latest_step(ckpt_dir) == 2
    with open(os.path.join(run_dir, "summary", "scalars.csv")) as fh:
        rows = fh.read().splitlines()[1:]
    tags = {r.split(",")[1] for r in rows}
    assert {"g_loss", "d_loss", "g_latent_loss", "train_psnr",
            "steps_per_sec"} <= tags
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows)
    cfg = registry.load_run_config(registry.resolve_run(
        os.path.join(tmp, "runs", "registry.json"), "toy"))
    assert cfg.net.image_size == SIZE and cfg.loss.lam_gdl == cfg.loss.lam_adv


def test_checkpoint_restores_the_full_state_bit_exactly(trained_run):
    tmp, run_dir, saved, opt, *_ = trained_run
    model, state = _port_train_setup(seed=99, n_embed=256)  # run_train's
    restore_checkpoint(os.path.join(run_dir, "training", "checkpoints"), state)
    assert state.step == 2 and state.g_sched.last_epoch == 2
    for k, v in state.generator.state_dict().items():
        assert torch.equal(v, saved[k]), k
    got = state.g_opt.state_dict()["state"]
    for i, s in opt["state"].items():
        for name, t in s.items():
            assert torch.equal(got[i][name], t), (i, name)
    raw = load_state_file(os.path.join(run_dir, "training", "checkpoints", "000002"))
    assert set(raw) == {"step", "generator", "discriminator", "g_opt", "d_opt",
                        "g_sched", "d_sched"}


def test_resume_continues_from_the_checkpoint(trained_run):
    tmp, run_dir, saved, _, run2, state2 = trained_run
    assert state2.step == 3 and state2.g_sched.last_epoch == 3
    # step 3 is no multiple of --step_save 2: the resumed run saved nothing
    assert latest_step(os.path.join(run2, "training", "checkpoints")) is None
    log_dir = os.path.join(run2, "log_dir")
    with open(os.path.join(log_dir, os.listdir(log_dir)[0])) as fh:
        log = fh.read()
    assert "resumed full training state from" in log
    assert "training steps 3 to 3" in log
    assert not torch.equal(state2.generator.state_dict()["bridge.O2F.conv.0.weight"],
                           saved["bridge.O2F.conv.0.weight"])


def test_prune_checkpoints_keeps_latest_and_milestones(tmp_path):
    model, state = _port_train_setup()
    for step in (1, 2, 3, 4):
        state.step = step
        save_checkpoint(str(tmp_path), state)
    assert prune_checkpoints(str(tmp_path), keep_last=1, keep_every=2) == [1, 3]
    assert sorted(os.listdir(tmp_path)) == ["000002", "000004"]


def test_run_test_scores_the_port_checkpoint(trained_run, train_tree, tmp_path,
                                             capsys):
    """``run_test --ckptfile <step dir>`` and ``--exp_tag`` score what the
    port trained; the two give the same records."""
    import shutil

    tmp, run_dir, saved, *_ = trained_run
    data = str(tmp_path / "data")
    shutil.copytree(os.path.join(train_tree, "toydata", "training"),
                    os.path.join(data, "toydata", "testing"))
    with open(os.path.join(data, "toydata", "toydata.json"), "w") as fh:
        json.dump({n: {"length": 12, "gt": [[3, 8]]} for n in ("01", "02")}, fh)
    ckpt = os.path.join(run_dir, "training", "checkpoints", "000002")
    assert all(torch.equal(v, saved[k])
               for k, v in load_generator_checkpoint(ckpt).items())
    base = ["--dataset_name", "toydata", "--data_dir", data, "--device", "cpu",
            "--image_size", str(SIZE)]
    a = run_test.main(base + ["--ckptfile", ckpt, "--save_dir", str(tmp_path / "a")])
    b = run_test.main(base + ["--exp_tag", "toy", "--save_dir", str(tmp_path / "b"),
                              "--registry", os.path.join(tmp, "runs", "registry.json")])
    assert "the optimal auc = " in capsys.readouterr().out
    with open(a["pickle"], "rb") as fa, open(b["pickle"], "rb") as fb:
        ra, rb = pickle.load(fa), pickle.load(fb)
    for key in ("rgb_img_pred_records", "op_fea_comm_records"):
        for x, y in zip(ra[key], rb[key]):
            assert np.isfinite(x).all()
            np.testing.assert_array_equal(x, y)


def test_run_train_pretrain_fix_branches_freeze_codebook(trained_run,
                                                          train_tree, tmp_path):
    """``--pretrain`` grafts an rgb branch from a ``.pth`` and an op branch
    from a port step dir; with ``--fix_branches --freeze_codebook`` one step
    leaves both branches' parameters and codebooks as grafted, while their
    BatchNorm statistics stay live.  ``--flownet_ckpt`` reads a wrapped
    ``.pth``."""
    tmp, run_dir, saved, *_ = trained_run
    rgb_pth = str(tmp_path / "rgb.pth")
    torch.save({k[4:]: v for k, v in saved.items() if k.startswith("rgb.")},
               rgb_pth)
    flow_pth = str(tmp_path / "flownet.pth")
    torch.save({"state_dict": FlowNet2SD().state_dict()}, flow_pth)
    step_dir = os.path.join(run_dir, "training", "checkpoints", "000002")
    _, state = run_train.main(_cli(
        train_tree, str(tmp_path), "--iterations", "1", "--pretrain",
        "--rgb_model_path", rgb_pth, "--op_model_path", step_dir,
        "--flownet_ckpt", flow_pth, "--fix_branches", "--freeze_codebook"))
    after = state.generator.state_dict()
    assert state.step == 1
    for key, val in saved.items():
        if not key.startswith(("rgb.", "op.")) or "num_batches" in key:
            continue
        assert torch.equal(after[key], val) != ("running_" in key), key


def test_run_train_cuda_without_gpu_raises(train_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda would run")
    argv = [a for a in _cli(train_tree, str(tmp_path)) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train.main(argv)


@pytest.mark.parametrize("extra,match", [
    (["--fetch_every_periods", "2"], "export-and-tools"),
    (["--async_checkpoints"], "export-and-tools"),
    (["--pretrain", "--rgb_model_path", "a.msgpack", "--op_model_path",
      "b.msgpack"], "msgpack"),
])
def test_run_train_flags_of_later_slices_raise(train_tree, tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        run_train.main(_cli(train_tree, str(tmp_path), "--iterations", "1", *extra))
