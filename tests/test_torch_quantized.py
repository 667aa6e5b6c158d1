"""PyTorch port: the int8 serving path (``models/quantized.py``,
``ops/int8_kernels.py``) against the JAX package's ``models/quantized.py``.

On the CPU the int8 wrappers take their plain versions (a float64
convolution of the int8 values, exact, then the float32 epilogue).  The
same seeded weights go to both packages through ``tools/weights.py``'s
inverse, the JAX package's ``convert_twostream``; the generator is the
released one at full widths, 32 codewords, 32x32 frames, batch 2.

Held, and why:

* exactness on exactly representable values, as ``tests/test_quantized.py``
  holds the JAX package: the weight round trip, the BN fold, the
  transposed-conv semantics, resident bitwise equal to non-resident, the
  ``out_scale`` chain, calibrated tracking dynamic;
* against JAX: the int8 weight tree bitwise; each conv's int32
  accumulators bitwise and its bf16 (or int8) output bitwise against the
  JAX conv run op by op; the 40 calibrated scales within 1 float32 ulp;
  the forward, op by op, within 1e-5 of the outputs' scale (the memory
  block's bf16 1x1 convs and the final tanh are two libraries' float ops)
  with the commit distances to 1e-5;
* under ``jax.jit`` XLA:CPU contracts the epilogue's ``acc * alpha +
  bias`` into a fused multiply-add (shown below on one conv: the jitted
  output is the FMA's rounding, not the kernel's), so a jitted JAX forward
  differs from the port where that flips an int8 rounding boundary: the
  port's bitwise target is JAX's op-by-op rounding.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ammcnet_aaai2021_tpu.data import get_dataset as j_get_dataset
from ammcnet_aaai2021_tpu.models import quantized as jq
from ammcnet_aaai2021_tpu.tools.make_toydata import make_toydata
from ammcnet_aaai2021_tpu.tools.torch_convert import convert_twostream
from ammcnet_aaai2021_torch.configs import NetConfig
from ammcnet_aaai2021_torch.data import get_dataset, native
from ammcnet_aaai2021_torch.eval import infer
from ammcnet_aaai2021_torch.models import (
    ConvTranspose2d,
    build_generator,
    init_weights,
)
from ammcnet_aaai2021_torch.models import quantized as pq
from ammcnet_aaai2021_torch.ops import int8_kernels as ik

torch.set_num_threads(2)
SIZE, N_EMBED = 32, 32


def _exact_weight(rng, shape, out_axis):
    """A kernel whose per-out-channel quantization is exact: integers in
    [-127, 127], one 127 in every output channel, times a channel scale."""
    ints = rng.integers(-127, 128, size=shape).astype(np.float32)
    idx = [0] * len(shape)
    for c in range(shape[out_axis]):
        idx[out_axis] = c
        ints[tuple(idx)] = 127.0
    scale_shape = [1] * len(shape)
    scale_shape[out_axis] = shape[out_axis]
    scales = rng.uniform(0.5, 2.0, size=shape[out_axis]).astype(np.float32)
    return ints * scales.reshape(scale_shape)


def _exact_x(rng, shape):
    x = rng.integers(-127, 128, shape).astype(np.float32)
    x[0, 0, 0, 0] = 127.0  # dynamic scale exactly 1
    return x


def _site(w, out_axis, bias):
    q = pq._q_conv(torch.from_numpy(w), torch.from_numpy(bias), out_axis)
    return q


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


class TestExactness:
    def test_quant_weight_roundtrip_exact(self):
        rng = np.random.default_rng(0)
        w = _exact_weight(rng, (3, 3, 8, 16), out_axis=3)
        q = pq._quant_weight(torch.from_numpy(w), out_axis=3)
        back = q["w"].float() * q["scale"]
        np.testing.assert_allclose(back.numpy(), w, rtol=1e-6)

    def test_qconv_equals_float_conv_on_exact_values(self):
        rng = np.random.default_rng(1)
        w = _exact_weight(rng, (3, 3, 8, 16), out_axis=3)
        bias = rng.normal(size=16).astype(np.float32)
        x = _exact_x(rng, (2, 10, 10, 8))
        got = pq._qconv(torch.from_numpy(x), _site(w, 3, bias), relu=False)
        ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1),
                       padding=1).permute(0, 2, 3, 1) + torch.from_numpy(bias)
        # int32 accumulation is exact; only the final bf16 cast rounds
        np.testing.assert_allclose(_np(got), _np(ref.to(torch.bfloat16)),
                                   rtol=1e-6)

    def test_qconv_transpose_matches_the_ports_module(self):
        """The (kh, kw, out, in) quantization axis and the kernel layout
        agree with the generator's ConvTranspose2d (blocks.Up)."""
        rng = np.random.default_rng(2)
        w = _exact_weight(rng, (2, 2, 4, 8), out_axis=2)  # out 4, in 8
        bias = rng.normal(size=4).astype(np.float32)
        x = _exact_x(rng, (2, 6, 6, 8))
        got = pq._qconv_transpose(torch.from_numpy(x), _site(w, 2, bias))
        mod = ConvTranspose2d(8, 4, 2, stride=2)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
            mod.bias.copy_(torch.from_numpy(bias))
            ref = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)
        np.testing.assert_allclose(_np(got), _np(ref.to(torch.bfloat16)),
                                   rtol=1e-6)

    def test_bn_fold_exact(self):
        """folded conv + bias == conv -> inference BatchNorm, to float32
        accuracy."""
        rng = np.random.default_rng(3)
        w = torch.from_numpy(rng.normal(size=(3, 3, 4, 8)).astype(np.float32))
        g, b = (torch.from_numpy(a.astype(np.float32)) for a in (
            rng.uniform(0.5, 2, 8), rng.normal(size=8)))
        mu, var = (torch.from_numpy(a.astype(np.float32)) for a in (
            rng.normal(size=8), rng.uniform(0.1, 2, 8)))
        x = torch.from_numpy(rng.normal(size=(2, 4, 6, 6)).astype(np.float32))
        conv = F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)
        y_ref = F.batch_norm(conv, mu, var, g, b, eps=1e-5)
        kf, bf = pq._fold_bn(w, g, b, mu, var)
        y_fold = F.conv2d(x, kf.permute(3, 2, 0, 1), bf, padding=1)
        np.testing.assert_allclose(y_fold.numpy(), y_ref.numpy(), rtol=1e-4,
                                   atol=1e-5)

    def test_qconv_out_scale_emits_int8_and_chains_exactly(self):
        """The residency epilogue returns int8, and the next conv (whose
        act_scale it used) reproduces the bf16 hand-off bitwise."""
        rng = np.random.default_rng(19)
        q0 = _site(_exact_weight(rng, (3, 3, 32, 32), 3), 3,
                   rng.normal(size=32).astype(np.float32))
        q1 = _site(_exact_weight(rng, (3, 3, 32, 32), 3), 3,
                   rng.normal(size=32).astype(np.float32))
        x = torch.from_numpy(_exact_x(rng, (2, 8, 8, 32)))
        s1 = torch.tensor([0.37], dtype=torch.float32)
        q1c = dict(q1, act_scale=s1)
        y8 = pq._qconv(x, q0, relu=True, out_scale=s1)
        assert y8.dtype == torch.int8
        got = pq._qconv(y8, q1c, relu=True)
        ref = pq._qconv(pq._qconv(x, q0, relu=True), q1c, relu=True)
        assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def built():
    """The released generator's widths (float32 weights, 32 codewords),
    seeded, BatchNorm statistics moved off their init; its state dict, the
    JAX variables of the same weights, and both int8 trees."""
    cfg = NetConfig(dtype="float32", n_embed=N_EMBED, use_memory_kernel=False)
    net = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(3)).eval()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                # small shifts: random-init activations are small, a large
                # mean shift would ReLU-zero the net
                m.running_mean.copy_(0.01 * torch.rand(m.running_mean.shape,
                                                       generator=g))
                m.running_var.copy_(1 + 0.1 * torch.rand(m.running_var.shape,
                                                         generator=g))
                m.weight.copy_(1 + 0.1 * torch.rand(m.weight.shape,
                                                    generator=g))
    sd = net.state_dict()
    variables = jax.tree.map(jnp.asarray, convert_twostream(
        {k: v.numpy() for k, v in sd.items()}))
    return {"cfg": cfg, "net": net, "sd": sd, "variables": variables,
            "pq": pq.quantize_twostream_variables(sd),
            "jq": jq.quantize_twostream_variables(variables)}


@pytest.fixture(scope="module")
def jax_eager(built):
    """The JAX int8 forward op by op (not jitted, so XLA fuses no
    multiply-add) on one batch, and its calibration on that batch by an
    op-by-op record pass (``calibrate_act_scales`` with ``jax.jit`` made
    the identity while it runs)."""
    rgb, op = _batch(11)
    fwd = _jax_fwd(built)
    jit = jax.jit
    jax.jit = lambda f: f
    try:
        qcal = jq.calibrate_act_scales(fwd, built["jq"],
                                       [(jnp.asarray(rgb), jnp.asarray(op))])
    finally:
        jax.jit = jit
    out = fwd(built["jq"], jnp.asarray(rgb), jnp.asarray(op))
    return {"batch": (rgb, op), "out": out, "qcal": qcal}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (2, SIZE, SIZE, 12)).astype(np.float32),
            rng.uniform(-1, 1, (2, SIZE, SIZE, 6)).astype(np.float32))


def _nchw(*arrays):
    return tuple(torch.from_numpy(a).permute(0, 3, 1, 2) for a in arrays)


def _port(built, qvars, resident=True):
    return pq.make_quantized_forward(
        qvars, embed_dim=64, n_embed=N_EMBED, k=built["cfg"].k,
        per_sample_diff=True, resident=resident)


def _jax_fwd(built, resident=True):
    return jq.make_quantized_forward(embed_dim=64, n_embed=N_EMBED,
                                     k=built["cfg"].k, per_sample_diff=True,
                                     resident=resident)


def _run(model, rgb, op):
    with torch.inference_mode():
        r, o, (dr, do), _ = model(*_nchw(rgb, op))
    return r.permute(0, 2, 3, 1).numpy(), o.permute(0, 2, 3, 1).numpy(), \
        dr.numpy(), do.numpy()


def _sites(tree, base=""):
    for k, v in tree.items():
        path = f"{base}/{k}" if base else k
        if "wk" in v or "w" in v:
            yield path, v
        else:
            yield from _sites(v, path)


def _lookup(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


class TestAgainstJax:
    def test_int8_weight_tree_is_jaxs(self, built):
        """Every site's int8 weights, scales and folded biases bitwise, and
        the kernel layout holds the same int8 weights."""
        port = {"streams": built["pq"]["streams"],
                "bridge": built["pq"]["bridge"]}
        sites = dict(_sites(port))
        assert len(sites) == 40
        for path, q in sites.items():
            j = _lookup(built["jq"], path)
            for key in ("w", "scale", "bias"):
                np.testing.assert_array_equal(q[key].numpy(),
                                              np.asarray(j[key]),
                                              err_msg=f"{path} {key}")
            w = q["w"]
            if path.endswith("/up"):
                kh, kw, cout, cin = w.shape
                rows = 4 * cout
                back = q["wk"][:rows, 0, :cin].reshape(w.shape)
            else:
                kh, kw, cin, cout = w.shape
                rows = cout
                back = q["wk"][:cout, :, :cin].reshape(cout, 3, 3, cin) \
                    .permute(1, 2, 3, 0)
            assert torch.equal(back, w), path
            # the padding is zeros: rows past the output columns, channels
            # past Cin
            assert not q["wk"][rows:].any() and not q["wk"][:, :, cin:].any()
            assert q["wk"].shape[0] % 64 == 0 and q["wk"].shape[2] % 32 == 0
        # the memory blocks' float weights ride along unchanged
        mem = built["pq"]["mem"]["rgb"]
        assert torch.equal(mem["quan.enc.weight"],
                           built["sd"]["rgb.vq_down3.quan.enc.weight"])

    @pytest.mark.parametrize("path,shape", [
        ("streams/rgb/inc/conv0", (2, SIZE, SIZE, 12)),
        ("streams/op/inc/conv0", (2, SIZE, SIZE, 6)),
        ("streams/rgb/down3/conv1", (2, 4, 4, 512)),
        ("streams/rgb/up3/conv/conv0", (2, SIZE, SIZE, 128)),
        ("streams/op/outc", (2, SIZE, SIZE, 64)),
        ("streams/rgb/up1/up", (2, 4, 4, 512)),
        ("bridge/F2O/conv0", (2, 4, 4, 512)),
    ])
    def test_conv_accumulators_and_outputs_are_jaxs(self, built, path,
                                                    shape):
        """One conv, op by op in both: the int32 accumulators bitwise
        (JAX's ``preferred_element_type=int32`` conv), the bf16 output
        bitwise (with ReLU for a DoubleConv's conv), and for a conv0 the
        int8 residency output at a calibrated scale bitwise."""
        rng = np.random.default_rng(23)
        x = rng.normal(0, 1, shape).astype(np.float32)
        q, jqs = _lookup(built["pq"], path), _lookup(built["jq"], path)
        xq, sx = jq._quant_act(jnp.asarray(x))
        up = path.endswith("/up")
        if up:
            acc = jax.lax.conv_transpose(
                xq, jqs["w"], (2, 2), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                transpose_kernel=True, preferred_element_type=jnp.int32)
            want = jq._qconv_transpose(jnp.asarray(x), jqs)
        else:
            acc = jax.lax.conv_general_dilated(
                xq, jqs["w"], (1, 1), "SAME", dimension_numbers=jq._DN,
                preferred_element_type=jnp.int32)
            relu = not path.endswith("outc")
            want = jq._qconv(jnp.asarray(x), jqs, relu)
        pxq, psx = pq._quant_act(torch.from_numpy(x))
        np.testing.assert_array_equal(pxq.numpy(), np.asarray(xq))
        assert np.float32(psx) == np.float32(sx)
        cout = q["scale"].numel()
        args = (ik.pad_channels(pxq).contiguous(), q["wk"], psx.reshape(1),
                q["scale"], q["bias"], cout)
        got_acc = (ik.qconv_transpose2x2_int8 if up else ik.qconv3x3_int8)(
            *args, acc=True)
        np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
        got = (pq._qconv_transpose(torch.from_numpy(x), q) if up
               else pq._qconv(torch.from_numpy(x), q, relu))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got),
                                      np.asarray(want, np.float32))
        if path.endswith("conv0"):
            s = jnp.float32(0.0123)
            want8 = jq._qconv(jnp.asarray(x), jqs, True, out_scale=s)
            got8 = pq._qconv(torch.from_numpy(x), q, True,
                             out_scale=torch.tensor([0.0123]))
            np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))

    def test_xla_cpu_contracts_the_epilogue_under_jit(self, built):
        """The FMA finding: jitted, XLA:CPU rounds ``acc * alpha + bias``
        once (a fused multiply-add), op by op twice; the port (and its
        kernel, ``__fmul_rn``/``__fadd_rn``) rounds twice, as JAX op by
        op."""
        path = "streams/rgb/up3/conv/conv0"
        jqs = _lookup(built["jq"], path)
        x = np.random.default_rng(29).normal(
            0, 1, (2, SIZE, SIZE, 128)).astype(np.float32)
        xq, sx = jq._quant_act(jnp.asarray(x))
        acc = np.asarray(jax.lax.conv_general_dilated(
            xq, jqs["w"], (1, 1), "SAME", dimension_numbers=jq._DN,
            preferred_element_type=jnp.int32)).astype(np.float32)
        alpha = np.float32(sx) * np.asarray(jqs["scale"])
        bias = np.asarray(jqs["bias"])
        two = (acc * alpha + bias).astype(ml_dtypes.bfloat16)
        fused = (acc.astype(np.float64) * alpha + bias).astype(
            np.float32).astype(ml_dtypes.bfloat16)
        assert (two != fused).any()  # the two roundings do differ here
        eager = np.asarray(jq._qconv(jnp.asarray(x), jqs, False))
        jitted = np.asarray(jax.jit(lambda v: jq._qconv(v, jqs, False))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(eager, two)
        np.testing.assert_array_equal(jitted, fused)
        port = pq._qconv(torch.from_numpy(x), _lookup(built["pq"], path),
                         False)
        np.testing.assert_array_equal(_np(port), two.astype(np.float32))

    def test_forward_matches_jax_op_by_op(self, built, jax_eager):
        """The whole int8 forward, uncalibrated (dynamic scales), against
        JAX's op by op: every conv is bitwise (above); the memory block's
        bf16 1x1 convs and the final tanh are two libraries' float ops, so
        the predictions agree within 1e-5 of their scale and the commit
        distances to 1e-5."""
        r, o, dr, do = _run(_port(built, built["pq"]), *jax_eager["batch"])
        jr, jo, (jdr, jdo), _ = jax_eager["out"]
        for got, want in ((r, jr), (o, jo)):
            want = np.asarray(want, np.float32)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(dr, np.asarray(jdr), rtol=1e-5)
        np.testing.assert_allclose(do, np.asarray(jdo), rtol=1e-5)

    def test_calibrated_scales_are_jaxs(self, built, jax_eager):
        """40 sites, each scale within 1 float32 ulp of the JAX package's
        from the same batch, both record passes op by op (the input site's
        scale bitwise)."""
        port = _port(built, built["pq"])
        qcal = pq.calibrate_act_scales(port, built["pq"],
                                       [_nchw(*jax_eager["batch"])])
        jcal = jax_eager["qcal"]
        sites = dict(_sites({"streams": qcal["streams"],
                             "bridge": qcal["bridge"]}))
        assert len(sites) == 40
        for path, q in sites.items():
            got = np.float32(q["act_scale"].item())
            want = np.float32(_lookup(jcal, path)["act_scale"])
            assert abs(got - want) <= np.spacing(want), path
        got = sites["streams/rgb/inc/conv0"]["act_scale"].item()
        assert np.float32(got) == np.float32(
            jcal["streams"]["rgb"]["inc"]["conv0"]["act_scale"])

    def test_jitted_jax_forward_is_the_fma_rounding(self, built, jax_eager):
        """Jitted, the JAX forward drifts from its own op-by-op run (the
        contracted epilogue moves bf16 values by an ulp, and dynamic scales
        and int8 boundaries carry it on), while the port stays on the op by
        op run: the port is nearer, everywhere."""
        rgb, op = jax_eager["batch"]
        r, o, _, _ = _run(_port(built, built["pq"]), rgb, op)
        jr, jo, _, _ = jax.jit(_jax_fwd(built))(built["jq"], jnp.asarray(rgb),
                                                jnp.asarray(op))
        for got, jit, eager in ((r, jr, jax_eager["out"][0]),
                                (o, jo, jax_eager["out"][1])):
            jit, eager = (np.asarray(v, np.float32) for v in (jit, eager))
            assert np.abs(got - eager).max() < np.abs(jit - eager).max()

    def test_calibration_draws_the_jax_samplers_clips(self, tmp_path):
        """``calibrated_int8_from_dataset``'s sampler (seed 2017) gives the
        JAX sampler's batches, value for value."""
        root = make_toydata(str(tmp_path), num_train_videos=3,
                            num_test_videos=1, frames_per_video=12,
                            image_size=SIZE)
        train = os.path.join(root, "training")
        roots = dict(rgb_root=os.path.join(train, "frames"),
                     op_root=os.path.join(train, "flows"), image_size=SIZE)
        ours = get_dataset("rgb_op", "training", **roots)
        theirs = j_get_dataset("rgb_op", "training", **roots)
        for _ in range(2):
            a, b = ours.batch(4), theirs.batch(4)
            for key in ("rgb", "op"):
                np.testing.assert_array_equal(a[key], b[key])


class TestServing:
    def test_resident_int8_bit_equals_nonresident(self, built):
        """Calibrated, the resident forward (conv0 -> conv1 in int8) is
        bitwise the non-resident one; uncalibrated, residency is a
        no-op."""
        cal = _batch(17)
        rgb, op = _batch(18)
        res = _port(built, built["pq"])
        qcal = pq.calibrate_act_scales(res, built["pq"], [_nchw(*cal)])
        a = _run(_port(built, qcal, resident=True), rgb, op)
        b = _run(_port(built, qcal, resident=False), rgb, op)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        c = _run(_port(built, built["pq"], resident=True), rgb, op)
        d = _run(_port(built, built["pq"], resident=False), rgb, op)
        for x, y in zip(c, d):
            np.testing.assert_array_equal(x, y)

    def test_calibrated_matches_dynamic_on_its_calibration_set(self, built):
        """Calibrated on batch X and run on X: each static scale is the
        dynamic per-call scale (the input site's exactly), so the
        calibrated forward is the dynamic one, here bitwise (the port's
        record pass and its forward round alike)."""
        rgb, op = _batch(12)
        dyn = _port(built, built["pq"])
        qcal = pq.calibrate_act_scales(dyn, built["pq"], [_nchw(rgb, op)])
        _, sx = pq._quant_act(torch.from_numpy(rgb))
        assert np.float32(sx) == np.float32(
            qcal["streams"]["rgb"]["inc"]["conv0"]["act_scale"].item())
        a = _run(dyn, rgb, op)
        b = _run(_port(built, qcal), rgb, op)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def test_calibrated_tracks_dynamic_on_fresh_data(self, built):
        """On data the calibration never saw, static scales may clip rare
        maxima but the outputs stay close (correlation > 0.99)."""
        cal = [_nchw(*_batch(s)) for s in (13, 14, 15)]
        rgb, op = _batch(16)
        dyn = _port(built, built["pq"])
        qcal = pq.calibrate_act_scales(dyn, built["pq"], cal)
        a = _run(dyn, rgb, op)
        b = _run(_port(built, qcal), rgb, op)
        for x, y in zip(a[:2], b[:2]):
            assert np.isfinite(y).all()
            assert np.corrcoef(x.ravel(), y.ravel())[0, 1] > 0.99

    def test_int8_forward_tracks_the_float_generator(self, built):
        """Against the port's float32 generator on the same weights:
        predictions correlate above 0.97 and the commit distances agree to
        50 % (as the JAX package holds its int8 forward)."""
        rgb, op = _batch(7)
        r, o, dr, do = _run(_port(built, built["pq"]), rgb, op)
        with torch.inference_mode():
            fr, fo, (fdr, fdo), _ = built["net"](*_nchw(rgb, op))
        for got, ref in ((r, fr), (o, fo)):
            ref = ref.permute(0, 2, 3, 1).numpy()
            assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.97
        np.testing.assert_allclose(dr, fdr.numpy(), rtol=0.5)
        assert dr.shape == fdr.shape and do.shape == fdo.shape

    def test_scorer_takes_the_int8_forward(self, built, tmp_path):
        """``score_dataset`` scores with the int8 module as with the
        generator: finite records, one per frame."""
        root = make_toydata(str(tmp_path), num_train_videos=1,
                            num_test_videos=2, frames_per_video=10,
                            image_size=SIZE)
        model = _port(built, built["pq"])
        result, fps = infer.score_dataset(
            model, os.path.join(root, "testing", "frames"),
            os.path.join(root, "testing", "flows"), "toydata",
            image_size=SIZE, window_batch=4)
        assert fps > 0
        for key in ("rgb_img_pred_records", "op_fea_comm_records"):
            assert [len(r) for r in result[key]] == [10, 10]
            assert all(np.isfinite(r).all() for r in result[key])

    def test_calibration_needs_every_site(self, built):
        """A record that misses sites raises: the forward's structure
        drifted."""
        class Partial(torch.nn.Module):
            def forward(self, rgb_x, op_x, record=None):
                record["streams/rgb/inc/conv0"] = rgb_x.abs().amax()

        with pytest.raises(RuntimeError, match="recorded 1 sites"):
            pq.calibrate_act_scales(Partial(), built["pq"],
                                    [_nchw(*_batch(3))])

    def test_native_loader_calibrates_from_jpeg_frames(self, built,
                                                       tmp_path):
        """With the native loader the calibration reads the training split's
        JPEG frames through ``data/native.py`` (no cv2 needed) and gets the
        scales cv2's frames give within 1 LSB of decode: all 40 sites, each
        within 2 % of the cv2 run's."""
        root = make_toydata(str(tmp_path), num_train_videos=2,
                            num_test_videos=1, frames_per_video=10,
                            image_size=SIZE)
        data_dir = os.path.dirname(root)
        cfg = NetConfig(n_embed=N_EMBED, use_memory_kernel=False)
        runs = [pq.calibrated_int8_from_dataset(
            cfg, built["sd"], data_dir, "toydata", SIZE, calib_batches=1,
            calib_batch_size=2, use_native_loader=native_loader)[1]
            for native_loader in (False, True)]
        a, b = (dict(_sites({"streams": q["streams"],
                             "bridge": q["bridge"]})) for q in runs)
        assert len(a) == len(b) == 40
        for path in a:
            np.testing.assert_allclose(b[path]["act_scale"].item(),
                                       a[path]["act_scale"].item(),
                                       rtol=2e-2, err_msg=path)
        assert isinstance(native.NativeClipLoader("rgb", SIZE)._frame(
            os.path.join(root, "training", "frames", "01", "000.jpg")),
            np.ndarray)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions_without_counting(self):
        rng = np.random.default_rng(31)
        x = torch.from_numpy(rng.integers(-127, 128, (1, 5, 6, 32),
                                          dtype=np.int8))
        wk = torch.from_numpy(rng.integers(-127, 128, (64, 9, 32),
                                           dtype=np.int8))
        wt = torch.from_numpy(rng.integers(-127, 128, (64, 1, 32),
                                           dtype=np.int8))
        sx = torch.tensor([0.01])
        scale, bias = torch.rand(10), torch.rand(10)
        before = (ik.qconv3x3_int8.launches,
                  ik.qconv_transpose2x2_int8.launches)
        assert torch.equal(ik.qconv3x3_int8(x, wk, sx, scale, bias, 10),
                           ik.qconv3x3_int8_ref(x, wk, sx, scale, bias, 10))
        assert ik.qconv_transpose2x2_int8(
            x, wt, sx, scale, bias, 10).shape == (1, 10, 12, 10)
        assert (ik.qconv3x3_int8.launches,
                ik.qconv_transpose2x2_int8.launches) == before

    def test_layouts_the_kernel_does_not_take_raise(self):
        x = torch.zeros((1, 4, 4, 12), dtype=torch.int8)  # Cin not padded
        wk = torch.zeros((64, 9, 12), dtype=torch.int8)
        args = (torch.tensor([1.0]), torch.ones(8), torch.zeros(8), 8)
        with pytest.raises(ValueError, match="Cin % 32"):
            ik.qconv3x3_int8(x, wk, *args)
        x = ik.pad_channels(x)
        with pytest.raises(ValueError, match="want contiguous"):
            ik.qconv3x3_int8(x, torch.zeros((60, 9, 32), dtype=torch.int8),
                             *args)
        with pytest.raises(ValueError, match="want contiguous"):
            ik.qconv_transpose2x2_int8(
                x, torch.zeros((64, 9, 32), dtype=torch.int8), *args)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its checks' code runs on CPU
    tensors too; its phases need the card)."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestChipSmokeInt8Check:
    """``chip_smoke.py``'s int8 check holds the forward's own kernel calls
    against the plain versions: every call of the first forward at each
    batch size, the sites read from the forward itself."""

    @pytest.fixture(scope="class")
    def qcal(self, built):
        return pq.calibrate_act_scales(_port(built, built["pq"]), built["pq"],
                                       [_nchw(*_batch(11))])

    def test_recorder_checks_each_batch_size_once(self, built, qcal):
        cs = _chip_smoke()
        calibrated, dynamic = _port(built, qcal), _port(built, built["pq"])
        rgb, op = _nchw(*_batch(12))
        with torch.inference_mode(), cs.Int8Recorder() as rec:
            dynamic(rgb, op, record={})  # a calibration's record pass
            calibrated(rgb, op)
            calibrated(rgb, op)  # a batch size seen: not checked again
            calibrated(rgb[:1], op[:1])
        assert pq.qconv3x3_int8 is ik.qconv3x3_int8  # restored
        assert [(b["windows"], b["record_pass"]) for b in rec.batches] == [
            (2, True), (1, False)]
        for b in rec.batches:
            assert b["calls"] == {"qconv3x3_int8": 34,
                                  "qconv_transpose2x2_int8": 6}
        assert rec.helper_calls == rec.kernel_calls == 4 * pq.N_SITES
        # the timed forward: the first scoring one at the largest batch,
        # each distinct launch once, the unpadded input widths
        kept = list(rec.timing.values())
        assert sum(len(t["sites"]) for t in kept) == pq.N_SITES
        assert {t["true_cin"] for t in kept
                if t["sites"][0].endswith("inc/conv0")} == {12, 6}
        assert {t["epilogue"] for t in kept} == {"int8", "bf16_relu", "bf16"}

    def test_recorder_fails_on_a_wrong_kernel_output(self, built, qcal,
                                                     monkeypatch, capsys):
        """A kernel whose output the forward uses is off by one value: the
        check exits non-zero."""
        import functools

        cs = _chip_smoke()
        real = ik.qconv_transpose2x2_int8

        @functools.wraps(real)
        def off_by_one(*args, **kwargs):
            out = real(*args, **kwargs)
            if not kwargs.get("acc"):
                out.view(-1)[7] += 1
            return out
        monkeypatch.setattr(pq, "qconv_transpose2x2_int8", off_by_one)
        rgb, op = _nchw(*_batch(12))
        with torch.inference_mode(), cs.Int8Recorder(), pytest.raises(
                SystemExit):
            _port(built, qcal)(rgb, op)
        err = capsys.readouterr().err
        assert "qconv_transpose2x2_int8 at streams/rgb/up1/up" in err
        assert "1 output differ" in err
