"""PyTorch port: the model family against the JAX package.

The VQ-VAE nets and their parts (``models/vqvae.py``), the plain UNet,
``UNetMemV4``, the non-residual memory stream and the two-stream generator
with each bridge, at small sizes, in float32.  Each JAX module is
initialized from a seed, its BatchNorm statistics and affine parameters set
to random numpy values, and its variables carried into the port's module by
``tools/weights.py`` (``load_state_dict`` strict).  Both run the same numpy
input (NHWC for JAX, NCHW for the port):

* eval mode: every output, commit distance and code;
* train mode (the batch statistics, the EMA codebook update): every
  output, the loss ``mean(prediction) + diff``, its gradient with respect
  to every parameter (``jax.grad`` against ``backward``, mapped by name
  through the same converter), and every buffer after the forward (JAX's
  ``mutable`` collections).

The memories take their plain lookup on both sides: the VQ-VAE family has
no Pallas in the JAX package.  That the port's kernel route computes the
same function is held op by op below (``quantize_topk(st_mode="topk",
train=True, use_kernel=True)``), and on the card by ``chip_smoke.py``.

Tolerance 1e-4 (absolute and relative), as in ``test_torch_models.py``:
float32 convolutions in XLA:CPU and oneDNN sum in different orders.
"""

import contextlib
import importlib.util
import io
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.models import NET_TAGS as J_NET_TAGS
from ammcnet_aaai2021_tpu.models import TwoStreamUNetMem as JTwoStream
from ammcnet_aaai2021_tpu.models import UNetMemStream as JStream
from ammcnet_aaai2021_tpu.models import UNetMemV4 as JUNetMemV4
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_tpu.models import vqvae as jvq
from ammcnet_aaai2021_tpu.models.blocks import UNet as JUNet
from ammcnet_aaai2021_torch.models import (
    NET_TAGS,
    TwoStreamUNetMem,
    UNet,
    UNetMemStream,
    UNetMemV4,
    init_weights,
)
from ammcnet_aaai2021_torch.models import vqvae as tvq
from ammcnet_aaai2021_torch.ops import memory as memory_op
from ammcnet_aaai2021_torch.ops.memory import Codebook, quantize_topk
from ammcnet_aaai2021_torch.runners import run_train
from ammcnet_aaai2021_torch.tools import summarize
from ammcnet_aaai2021_torch.tools.weights import (
    single_stream_state_from_jax,
    state_dict_from_jax,
    vqvae_state_from_jax,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small VQ-VAE nets' widths: trunk channels, residual channels,
# codeword width, codebook size
VQ_SMALL = dict(channel=32, n_res_channel=8, embed_dim=16, n_embed=32)


def _randomize_bn(variables, seed):
    """Random BatchNorm running stats and affine params (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "'bn" not in name:
            return x
        if name.endswith("['mean']") or name.endswith("['bias']"):
            return rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
        return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)  # var, scale

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _leaves(out):
    """A torch output (a tensor or nested tuples of them), flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [leaf for item in out for leaf in _leaves(item)]


def _assert_outputs(t_out, j_out):
    t_leaves, j_leaves = _leaves(t_out), jax.tree.leaves(j_out)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        t = t.detach().float().numpy()
        if t.ndim == 4:
            t = t.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(t, np.asarray(j), **TOL)


def _loss(leaves):
    """``mean(prediction) + diff``: the mean of each image-shaped leaf
    (the predictions) plus each scalar (the commit distances)."""
    return sum(x.mean() if x.ndim == 4 else x for x in leaves)


def check_module(jmod, tmod, convert, inputs, *, seed, preds,
                 train_arg=True, train=False):
    """``jmod`` and ``tmod`` on ``inputs`` (NHWC numpy), weights carried
    across by ``convert`` (JAX variables -> state dict).  Without ``train``:
    eval-mode outputs.  With it: train-mode outputs, the loss over the
    first ``preds`` outputs and every scalar output, its gradient with
    respect to every parameter, and every buffer after the forward."""
    jx = [jnp.asarray(x) for x in inputs]
    variables = _randomize_bn(
        jmod.init({"params": jax.random.PRNGKey(seed)}, *jx), seed)
    tmod.load_state_dict(convert(variables))
    tx = [_nchw(x) for x in inputs]
    flag = (train,) if train_arg else ()
    if not train:
        j_out = jmod.apply(variables, *jx, *flag)
        with torch.no_grad():
            t_out = tmod.eval()(*tx)
        _assert_outputs(t_out, j_out)
        return
    mutable = [c for c in variables if c != "params"]

    def j_loss(params):
        out, new = jmod.apply({**variables, "params": params}, *jx, *flag,
                              mutable=mutable)
        leaves = jax.tree.leaves(out)
        picked = leaves[:preds] + [x for x in leaves if x.ndim == 0]
        return sum(jnp.mean(x) if x.ndim == 4 else x for x in picked), (
            out, new)

    (j_val, (j_out, j_new)), j_grads = jax.value_and_grad(
        j_loss, has_aux=True)(variables["params"])
    tmod.train()
    t_out = tmod(*tx)
    leaves = _leaves(t_out)
    t_val = _loss(leaves[:preds] + [x for x in leaves if x.ndim == 0])
    t_val.backward()
    _assert_outputs(t_out, j_out)
    np.testing.assert_allclose(t_val.item(), float(j_val), **TOL)
    # the gradients under the parameters' names, the new buffers under
    # theirs
    want = convert({**variables, **j_new, "params": j_grads})
    params = dict(tmod.named_parameters())
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    for name, b in tmod.named_buffers():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(),
                                       err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# models/vqvae.py, part by part


@pytest.mark.parametrize("train", [False, True])
def test_resblock_matches_jax(rng, train):
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    check_module(jvq.ResBlock(8, jnp.float32), tvq.ResBlock(16, 8),
                 vqvae_state_from_jax, [x], seed=0, preds=1,
                 train_arg=False, train=train)


def test_resblock_keeps_the_input_unrectified():
    """The residual adds the input itself, negative values included."""
    block = tvq.ResBlock(4, 2)
    for p in block.parameters():
        torch.nn.init.zeros_(p)
    x = -torch.ones(1, 4, 3, 3)
    assert torch.equal(block(x), x)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_encoder_matches_jax(rng, stride):
    x = rng.normal(size=(2, 32, 32, 5)).astype(np.float32)
    check_module(jvq.Encoder(16, 2, 8, stride, jnp.float32),
                 tvq.Encoder(5, 16, 2, 8, stride), vqvae_state_from_jax,
                 [x], seed=1, preds=1, train_arg=False, train=True)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_decoder_matches_jax(rng, stride):
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    check_module(jvq.Decoder(3, 16, 2, 8, stride, jnp.float32),
                 tvq.Decoder(6, 3, 16, 2, 8, stride), vqvae_state_from_jax,
                 [x], seed=2, preds=1, train_arg=False, train=True)


@pytest.mark.parametrize("part", [tvq.Encoder, tvq.Decoder])
def test_unsupported_stride_raises_as_in_jax(part):
    args = (5, 16, 2, 8, 3) if part is tvq.Encoder else (6, 3, 16, 2, 8, 3)
    with pytest.raises(ValueError, match="unsupported stride"):
        part(*args)
    jpart = jvq.Encoder(16, 2, 8, 3) if part is tvq.Encoder else (
        jvq.Decoder(3, 16, 2, 8, 3))
    with pytest.raises(ValueError, match="unsupported stride"):
        jpart.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)))


# (k, residual_proj, use_dec): the classic net's, the top-k nets', the
# residual one's
MEMORIES = {"classic": (1, False, False), "topk": (2, False, True),
            "residual": (2, True, True)}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", sorted(MEMORIES))
def test_vq_memory_matches_jax(rng, kind, train):
    k, residual, use_dec = MEMORIES[kind]
    x = rng.normal(size=(2, 8, 8, 24)).astype(np.float32)
    jmod = jvq.VQMemory(16, 32, k, residual_proj=residual, use_dec=use_dec,
                        dtype=jnp.float32)
    tmod = tvq.VQMemory(24, 16, 32, k, residual_proj=residual,
                        use_dec=use_dec)
    check_module(jmod, tmod, vqvae_state_from_jax, [x], seed=3, preds=1,
                 train=train)


VQ_NETS = {"vqvae": (jvq.VQVAE, tvq.VQVAE),
           "vqvae_topk": (jvq.VQVAETopK, tvq.VQVAETopK),
           "vqvae_topk_res": (jvq.VQVAETopKRes, tvq.VQVAETopKRes)}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("tag", sorted(VQ_NETS))
def test_vq_net_matches_jax(rng, tag, train):
    jcls, tcls = VQ_NETS[tag]
    x = rng.normal(size=(2, 32, 32, 12)).astype(np.float32)
    check_module(jcls(out_channel=3, k=2, dtype=jnp.float32, **VQ_SMALL),
                 tcls(12, 3, k=2, **VQ_SMALL), vqvae_state_from_jax, [x],
                 seed=4, preds=1, train=train)


@pytest.mark.parametrize("train", [False, True])
def test_vq_twostream_matches_jax(rng, train):
    rgb = rng.normal(size=(2, 32, 32, 12)).astype(np.float32)
    op = rng.normal(size=(2, 32, 32, 6)).astype(np.float32)
    check_module(jvq.VQVAETopKTwoStream(rgb_out=3, op_out=2, k=2,
                                        dtype=jnp.float32, **VQ_SMALL),
                 tvq.VQVAETopKTwoStream(12, 6, 3, 2, k=2, **VQ_SMALL),
                 vqvae_state_from_jax, [rgb, op], seed=5, preds=2,
                 train=train)


def test_bridge_only_mask_matches_jax():
    jnet = jvq.VQVAETopKTwoStream(dtype=jnp.float32, **VQ_SMALL)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 12)),
                       jnp.zeros((1, 16, 16, 6)))["params"]
    flat = flax.traverse_util.flatten_dict(jvq.bridge_only_mask(params))
    want = {".".join(kp[:-1] + ("weight" if kp[-1] == "kernel" else kp[-1],)):
            val for kp, val in flat.items()}
    got = tvq.bridge_only_mask(tvq.VQVAETopKTwoStream(12, 6, **VQ_SMALL))
    assert got == want
    # 2 bridges x (2 residual blocks of 2 convolutions, 2 1x1s) x (weight,
    # bias)
    assert sum(got.values()) == 24


# ---------------------------------------------------------------------------
# the UNet trunk: plain UNet, UNetMemV4, the non-residual stream, the bridges


@pytest.mark.parametrize("train", [False, True])
def test_unet_matches_jax(rng, train):
    x = rng.normal(size=(2, 32, 32, 12)).astype(np.float32)
    check_module(JUNet(out_channels=3, dtype=jnp.float32), UNet(12, 3),
                 single_stream_state_from_jax, [x], seed=6, preds=1,
                 train=train)


@pytest.mark.parametrize("train", [False, True])
def test_unetmem_v4_matches_jax(rng, train):
    x = rng.normal(size=(2, 32, 32, 12)).astype(np.float32)
    check_module(JUNetMemV4(out_channels=3, embed_dim=16, n_embed=32, k=2,
                            dtype=jnp.float32),
                 UNetMemV4(12, 3, embed_dim=16, n_embed=32, k=2),
                 single_stream_state_from_jax, [x], seed=7, preds=1,
                 train=train)


@pytest.mark.parametrize("train", [False, True])
def test_nonresidual_stream_matches_jax(rng, train):
    x = rng.normal(size=(2, 32, 32, 6)).astype(np.float32)
    check_module(JStream(out_channels=2, embed_dim=16, n_embed=32, k=2,
                         dtype=jnp.float32, residual_memory=False),
                 UNetMemStream(6, 2, embed_dim=16, n_embed=32, k=2,
                               residual_memory=False),
                 single_stream_state_from_jax, [x], seed=8, preds=1,
                 train=train)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("bridge_kind", ["amft", "concat_dire", "add_dire"])
def test_twostream_bridge_matches_jax(rng, bridge_kind, train):
    rgb = rng.normal(size=(2, 16, 16, 12)).astype(np.float32)
    op = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    check_module(JTwoStream(rgb_out=3, op_out=2, embed_dim=16, n_embed=32,
                            k=2, bridge_kind=bridge_kind, dtype=jnp.float32),
                 TwoStreamUNetMem(12, 6, 3, 2, embed_dim=16, n_embed=32, k=2,
                                  dtype=torch.float32,
                                  bridge_kind=bridge_kind),
                 state_dict_from_jax, [rgb, op], seed=9, preds=2,
                 train=train)


def test_unknown_bridge_kind_raises():
    with pytest.raises(ValueError, match="bridge_kind"):
        TwoStreamUNetMem(bridge_kind="concat")


# ---------------------------------------------------------------------------
# the lookup's routing, the parameter totals, summarize, run_train


@pytest.mark.parametrize("k", [1, 2])
def test_topk_training_lookup_takes_b2_and_equals_the_plain_route(
        rng, monkeypatch, k):
    """``st_mode="topk"`` in training: with ``use_kernel`` the lookup goes
    through B2's wrapper (on CPU tensors, its plain version) and the EMA
    through ``ema_apply``; outputs, commit distance, codebook and the
    gradient reaching ``z`` equal the plain route's."""
    calls = []
    b2 = memory_op.quantize_topk_train_fused

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return b2(*args, **kwargs)

    monkeypatch.setattr(memory_op, "quantize_topk_train_fused", spy)
    embed = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    cb = Codebook(embed, torch.rand(32), embed * 0.5)
    z0 = torch.from_numpy(rng.normal(size=(2, 4, 4, 16)).astype(np.float32))
    runs = []
    for use_kernel in (True, False):
        z = z0.clone().requires_grad_()
        q, diff, q_st, new = quantize_topk(z, cb, k, train=True,
                                           use_kernel=use_kernel,
                                           st_mode="topk")
        (q.square().mean() + diff).backward()
        runs.append((q, diff, q_st, *new, z.grad))
    assert calls == [(32, 16)]
    for got, want in zip(*runs):
        assert torch.equal(got, want)


# JAX tests/test_models.py:46-88: the reference's torch totals
PARAM_TOTALS = [
    (lambda: UNetMemV4(12, 3, embed_dim=64, n_embed=512, k=2), 7_855_363),
    (lambda: tvq.VQVAE(27, 3), 1_413_443),
    (lambda: tvq.VQVAETopK(27, 3), 1_421_763),
    (lambda: tvq.VQVAETopKRes(27, 3), 1_442_371),
    (lambda: tvq.VQVAETopKTwoStream(27, 16), 3_028_613),
]


@pytest.mark.parametrize("build,total", PARAM_TOTALS)
def test_parameter_totals_match_the_jax_tests(build, total):
    assert sum(p.numel() for p in build().parameters()) == total


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tag", NET_TAGS)
def test_summarize_totals_equal_the_jax_packages(tag):
    """``tools.summarize --device cpu``: its total and its non-parameter
    state equal the JAX package's for the tag (from the shapes of its
    ``init``, as JAX ``tools/summarize.py`` counts), and equal the totals
    ``chip_smoke.py`` holds the card's run to."""
    assert J_NET_TAGS == NET_TAGS
    jcfg = JNetConfig(net_tag=tag, dtype="float32", use_pallas_memory=False)
    inputs = [jnp.zeros((1, 64, 64, jcfg.in_channel[0]))]
    if "twostream" in tag:
        inputs.append(jnp.zeros((1, 64, 64, jcfg.in_channel[1])))
    shapes = jax.eval_shape(j_build_generator(jcfg).init,
                            jax.random.PRNGKey(0), *inputs)
    count = {c: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
             for c, tree in shapes.items()}
    j_total = count.pop("params")
    j_state = sum(count.values())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        total = summarize.main(["--net_tag", tag, "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0] == f"net_tag: {tag}"
    printed = {line.rsplit(None, 1)[0].strip(): line.rsplit(None, 1)[1]
               for line in lines[1:]}
    assert total == j_total == int(printed["TOTAL (params)"].replace(",", ""))
    assert int(printed["non-param state"].replace(",", "")) == j_state
    assert _chip_smoke().SUMMARIZE_TOTALS[tag] == total


def test_summarize_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        summarize.main(["--net_tag", "unet"])


@pytest.mark.parametrize("tag,data_type", [
    ("vqvae", "rgb"), ("unet", "op"), ("vqvae_twostream", "rgb_op")])
def test_run_train_rejects_the_family_before_any_work(tmp_path, tag,
                                                      data_type):
    with pytest.raises(ValueError, match="no training path"):
        run_train.main(["--net_tag", tag, "--data_type", data_type,
                        "--dataset_name", "toydata", "--data_dir",
                        str(tmp_path / "missing"), "--save_dir",
                        str(tmp_path / "runs"), "--device", "cpu"])
    assert not (tmp_path / "runs").exists()


def test_init_weights_seeds_the_vq_codebooks():
    nets = [init_weights(tvq.VQVAETopKTwoStream(12, 6, **VQ_SMALL),
                         torch.Generator().manual_seed(3)) for _ in range(2)]
    for (ka, va), (kb, vb) in zip(nets[0].state_dict().items(),
                                  nets[1].state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    q = nets[0].quantize_b_2.quantize
    assert torch.equal(q.embed, q.embed_avg) and not q.cluster_size.any()
    assert q.st_mode == "topk"
