"""PyTorch port: generator modules and the weight bridge against JAX.

Each JAX module (float32, its memory kernel in Pallas interpret mode) is
initialized from a seed, its BatchNorm statistics and affine parameters set
to random numpy values so eval-mode parity means something, and its
variables carried into the port's module with ``tools/weights.py``.  Both
run the same numpy input (NHWC for JAX, NCHW for the port).

Tolerance 1e-4 (absolute and relative) on outputs and commit distances:
float32 convolutions in XLA:CPU and oneDNN sum in different orders, and the
error grows over up to 19 stacked convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_tpu.models.blocks import DoubleConv as JDoubleConv
from ammcnet_aaai2021_tpu.models.blocks import Down as JDown
from ammcnet_aaai2021_tpu.models.blocks import Up as JUp
from ammcnet_aaai2021_tpu.models.memory_module import (
    EncQuanDecResTopK as JEncQuanDecResTopK,
)
from ammcnet_aaai2021_tpu.models.unet_mem import TwoStreamUNetMem as JTwoStream
from ammcnet_aaai2021_tpu.tools.torch_convert import convert_twostream
from ammcnet_aaai2021_torch.configs import NetConfig
from ammcnet_aaai2021_torch.models import (
    DoubleConv,
    Down,
    EncQuanDecResTopK,
    TwoStreamUNetMem,
    Up,
    build_generator,
    init_weights,
)
from ammcnet_aaai2021_torch.tools.weights import (
    double_conv_state,
    down_state,
    load_generator_checkpoint,
    memory_state,
    state_dict_from_jax,
    up_state,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


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


def _jax_vars(module, seed, *inputs):
    variables = module.init({"params": jax.random.PRNGKey(seed)},
                            *(jnp.asarray(x) for x in inputs))
    return _randomize_bn(variables, seed)


def _strip(state, prefix="m."):
    return {k[len(prefix):]: v for k, v in state.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_double_conv_matches_jax(rng):
    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    jmod = JDoubleConv(8, dtype=jnp.float32)
    v = _jax_vars(jmod, 0, x)
    mod = DoubleConv(5, 8).eval()
    mod.load_state_dict(_strip(double_conv_state("m", v["params"],
                                                 v["batch_stats"])))
    with torch.no_grad():
        got = mod(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(jmod.apply(v, x)), **TOL)


def test_down_matches_jax(rng):
    x = rng.normal(size=(2, 10, 10, 6)).astype(np.float32)
    jmod = JDown(12, dtype=jnp.float32)
    v = _jax_vars(jmod, 1, x)
    mod = Down(6, 12).eval()
    mod.load_state_dict(_strip(down_state("m", v["params"], v["batch_stats"])))
    with torch.no_grad():
        got = mod(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(jmod.apply(v, x)), **TOL)


@pytest.mark.parametrize("skip_size", [10, 11])  # 11: odd, exercises the pad
def test_up_matches_jax(rng, skip_size):
    x1 = rng.normal(size=(2, 5, 5, 16)).astype(np.float32)
    x2 = rng.normal(size=(2, skip_size, skip_size, 8)).astype(np.float32)
    jmod = JUp(6, dtype=jnp.float32)
    v = _jax_vars(jmod, 2, x1, x2)
    mod = Up(16, 6).eval()
    mod.load_state_dict(_strip(up_state("m", v["params"], v["batch_stats"])))
    with torch.no_grad():
        got = mod(_nchw(x1), _nchw(x2))
    assert got.shape == (2, 6, skip_size, skip_size)
    np.testing.assert_allclose(_nhwc(got), np.asarray(jmod.apply(v, x1, x2)),
                               **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_residual_memory_block_matches_jax(rng, fused):
    x = rng.normal(size=(2, 4, 4, 32)).astype(np.float32)
    jmod = JEncQuanDecResTopK(32, 16, 32, k=2, dtype=jnp.float32,
                              use_pallas=fused, per_sample_diff=True)
    v = _jax_vars(jmod, 3, x)
    mod = EncQuanDecResTopK(32, 16, 32, k=2, use_kernel=fused,
                            per_sample_diff=True).eval()
    mod.load_state_dict(_strip(memory_state("m", v["params"], v["codebook"])))
    jout, jdiff, jcode = jmod.apply(v, x)
    with torch.no_grad():
        out, diff, code = mod(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_nhwc(code), np.asarray(jcode), **TOL)
    np.testing.assert_allclose(diff.numpy(), np.asarray(jdiff), **TOL)


@pytest.fixture(scope="module")
def twostream_pair():
    """A JAX two-stream generator at full widths (n_embed 64, k 2) and the
    port's, holding the same random weights."""
    rng = np.random.default_rng(4)
    rgb = rng.normal(size=(2, 32, 32, 12)).astype(np.float32)
    op = rng.normal(size=(2, 32, 32, 6)).astype(np.float32)
    jnet = JTwoStream(rgb_out=3, op_out=2, embed_dim=64, n_embed=64, k=2,
                      dtype=jnp.float32, use_pallas=True, per_sample_diff=True)
    v = _jax_vars(jnet, 5, rgb, op)
    net = TwoStreamUNetMem(12, 6, 3, 2, embed_dim=64, n_embed=64, k=2,
                           dtype=torch.float32, use_kernel=True,
                           per_sample_diff=True).eval()
    net.load_state_dict(state_dict_from_jax(v))  # strict: every name maps
    return jnet, v, net, rgb, op


def test_twostream_forward_matches_jax(twostream_pair):
    jnet, v, net, rgb, op = twostream_pair
    j_rgb, j_op, (j_rd, j_od), (j_rc, j_oc) = jnet.apply(v, rgb, op)
    with torch.no_grad():
        t_rgb, t_op, (t_rd, t_od), (t_rc, t_oc) = net(_nchw(rgb), _nchw(op))
    assert t_rgb.dtype == torch.float32 and t_rgb.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(_nhwc(t_rgb), np.asarray(j_rgb), **TOL)
    np.testing.assert_allclose(_nhwc(t_op), np.asarray(j_op), **TOL)
    np.testing.assert_allclose(t_rd.numpy(), np.asarray(j_rd), **TOL)
    np.testing.assert_allclose(t_od.numpy(), np.asarray(j_od), **TOL)
    np.testing.assert_allclose(_nhwc(t_rc), np.asarray(j_rc), **TOL)
    np.testing.assert_allclose(_nhwc(t_oc), np.asarray(j_oc), **TOL)


def test_parameter_count_matches_jax():
    """The released configuration: 25,049,029 parameters in both packages
    (BatchNorm statistics and the codebooks are buffers / non-param state)."""
    jgen = j_build_generator(JNetConfig(), per_sample_diff=True)
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 12)), jnp.zeros((1, 32, 32, 6)))
    j_count = sum(int(np.prod(x.shape))
                  for x in jax.tree.leaves(shapes["params"]))
    gen = build_generator(NetConfig())
    assert sum(p.numel() for p in gen.parameters()) == j_count == 25_049_029


def test_state_dict_round_trips_through_jax_converter(tmp_path):
    """state_dict_from_jax inverts torch_convert.convert_twostream exactly,
    and a saved state dict loads back through load_generator_checkpoint."""
    net = build_generator(NetConfig(n_embed=64))
    init_weights(net, torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(10)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g))
            m.weight.data.copy_(torch.rand(m.weight.shape, generator=g))
    sd = net.state_dict()
    back = state_dict_from_jax(convert_twostream(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for key, val in sd.items():
        assert back[key].dtype == val.dtype, key
        assert torch.equal(back[key], val), key
    path = tmp_path / "generator.pth"
    torch.save({"state_dict": sd}, path)
    loaded = load_generator_checkpoint(str(path))
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_init_weights_is_seeded():
    a = init_weights(build_generator(NetConfig(n_embed=32)),
                     torch.Generator().manual_seed(1))
    b = init_weights(build_generator(NetConfig(n_embed=32)),
                     torch.Generator().manual_seed(1))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    q = a.rgb.vq_down3.quan.quantize
    assert torch.equal(q.embed, q.embed_avg) and not q.cluster_size.any()


@pytest.mark.parametrize("tag,error", [
    ("unet_vq", ValueError), ("unet_vq_res", ValueError),
    ("unet_vq_topk", ValueError), ("twostream_add_dire", ValueError),
    ("unet", NotImplementedError), ("vqvae_twostream", NotImplementedError),
    ("no_such_net", ValueError)])
def test_factory_rejects_tags_outside_the_slice(tag, error):
    with pytest.raises(error):
        build_generator(NetConfig(net_tag=tag))


def test_factory_builds_the_as_shipped_alias():
    net = build_generator(NetConfig(net_tag="twostream_concat_dire",
                                    n_embed=32))
    assert isinstance(net, TwoStreamUNetMem) and net.dtype == torch.bfloat16
    assert net.rgb.vq_down3.quan.quantize.use_kernel
