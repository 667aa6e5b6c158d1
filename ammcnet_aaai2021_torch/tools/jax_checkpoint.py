"""Read the JAX package's checkpoints without JAX: flax ``.msgpack`` files
and orbax step directories.

Both readers return flax's tree form (nested dicts, lists for sequences)
of numpy arrays; :func:`generator_state_dict` and
:func:`restore_jax_train_state` then map it to the port's names through the
name map of :mod:`.weights`.

* :func:`read_msgpack` is a small pure-Python msgpack decoder for what
  ``flax.serialization.to_bytes`` writes: nil, bool, ints, float32/64,
  str, bin, array, map and ext, with flax's ext types (1 ``ndarray`` and 3
  ``npscalar``: a msgpack ``(shape, dtype name, C-order bytes)`` triple; 2
  ``native_complex`` raises) and its chunked arrays (a map carrying
  ``__msgpack_chunked_array__``).  bfloat16 leaves are widened to float32
  bit-exactly (the 16 bits become float32's high half).
* :func:`read_orbax` rebuilds the tree of an orbax ``StandardCheckpointer``
  step directory from its ``_METADATA`` and reads each leaf with
  ``tensorstore`` (OCDBT + zarr), which needs no JAX.  On a host without
  tensorstore it raises ``ImportError`` naming the converter below.

A step directory holds either a generator's variables
``{'params', 'batch_stats', 'codebook'}`` or the JAX training loop's full
train state (``step``, ``g_params``, ``g_state``, ``g_opt_state``,
``d_params``, ``d_opt_state``); :func:`generator_variables` takes the
generator's slice of either, as the JAX package's
``train/checkpoint.load_generator_variables`` does.

Converter, for a host that has tensorstore::

  python -m ammcnet_aaai2021_torch.tools.jax_checkpoint SRC DST

``SRC`` is a ``.msgpack`` file or an orbax step directory.  Generator
variables become a generator ``.pth`` at ``DST`` under the reference
names; a full train state becomes the port's step directory
``DST/<step:06d>/state.pt`` (generator, discriminator, both Adams with
optax's ``mu``/``nu``/``count`` as ``exp_avg``/``exp_avg_sq``/``step``,
both schedulers at the step), which ``run_train --resume <run>`` continues
when ``DST`` is ``<run>/training/checkpoints``.  A ``--fix_branches``
run's generator optimizer (optax ``masked`` chains) converts to the port's
bridge-only Adam.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

CONVERTER = "python -m ammcnet_aaai2021_torch.tools.jax_checkpoint"

# flax.serialization's ext type codes
EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# msgpack


class _Decoder:
    """msgpack's formats (big-endian), decoded from one buffer."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str
        if b in sized:
            return str(self.take(self.unpack(sized[b])), "utf-8")
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self.unpack(scalar[b])
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        if b in sized:
            return self.ext(self.unpack(sized[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def array(self, n: int) -> List:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_NATIVE_COMPLEX:
            raise ValueError("msgpack: a complex leaf (flax ext type 2, "
                             "native_complex) has no place in a checkpoint "
                             "the port reads")
        raise ValueError(f"msgpack: unknown ext type {code}")


def widen_bfloat16(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> the same values in float32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray encoding: a msgpack ``(shape, dtype name, bytes)``."""
    dec = _Decoder(payload)
    shape, name, data = dec.value()
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype="<u2").reshape(shape)
        return widen_bfloat16(bits)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays (``{'__msgpack_chunked_array__': True,
    'shape': {'0': ..}, 'chunks': {'0': ..}}``) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(path: str) -> Any:
    """The tree ``flax.serialization.to_bytes`` wrote to ``path``, as nested
    dicts of numpy arrays (bfloat16 widened to float32)."""
    with open(path, "rb") as fh:
        dec = _Decoder(fh.read())
    tree = dec.value()
    if dec.pos != len(dec.buf):
        raise ValueError(f"{path}: {len(dec.buf) - dec.pos} bytes after the "
                         "msgpack object")
    return _unchunk(tree)


# ---------------------------------------------------------------------------
# orbax

SEQUENCE_KEY = 1  # orbax's KeyType.SEQUENCE; 2 is KeyType.DICT


def _sequences_to_lists(node: Any) -> Any:
    if isinstance(node, dict):
        node = {k: _sequences_to_lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
    return node


def read_orbax(step_dir: str) -> Dict:
    """The tree of an orbax step directory the JAX package wrote, as nested
    dicts (lists for sequences) of numpy arrays; masked-out or empty nodes
    (optax's ``MaskedNode``, ``EmptyState``) are ``None``.  Needs
    tensorstore; raises ``ImportError`` without it."""
    meta_path = os.path.join(step_dir, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{step_dir}: no _METADATA, not an orbax "
                                "step directory")
    try:
        import tensorstore as ts
    except ImportError as exc:
        raise ImportError(
            f"{step_dir} is an orbax checkpoint of the JAX package; reading "
            "it needs the tensorstore package, which this host lacks.  "
            "Convert it on a host that has tensorstore: "
            f"{CONVERTER} {step_dir} <dst> (a generator .pth, or for a full "
            "train state a step directory that run_train --resume takes)"
        ) from exc
    with open(meta_path) as fh:
        meta = json.load(fh)
    base = os.path.abspath(step_dir)
    zarr = "zarr3" if meta.get("use_zarr3") else "zarr"
    context = ts.Context()

    def spec(name: str) -> Dict:
        if meta.get("use_ocdbt", True):
            kvstore = {"driver": "ocdbt", "base": f"file://{base}"}
            return {"driver": zarr, "kvstore": kvstore, "path": name}
        return {"driver": zarr,
                "kvstore": {"driver": "file", "path": os.path.join(base, name)}}

    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [(int(k["key"]) if k["key_type"] == SEQUENCE_KEY else k["key"])
                for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            leaves.append((keys, None))
            continue
        if value["value_type"] not in ("jax.Array", "np.ndarray", "scalar"):
            raise ValueError(f"{step_dir}: leaf {keys} of type "
                             f"{value['value_type']!r} is not read here")
        name = ".".join(str(k) for k in keys)
        leaves.append((keys, ts.open(spec(name), open=True, context=context)))
    tree: Dict = {}
    for keys, future in leaves:
        leaf = None
        if future is not None:
            arr = np.asarray(future.result().read().result())
            if arr.dtype.name == "bfloat16":
                arr = widen_bfloat16(arr.view(np.uint16))
            leaf = arr
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return _sequences_to_lists(tree)


def read_jax_checkpoint(path: str) -> Any:
    """A ``.msgpack`` file or an orbax step directory, read."""
    if path.endswith(".msgpack"):
        return read_msgpack(path)
    return read_orbax(path)


# ---------------------------------------------------------------------------
# the port's names


def is_train_state(tree: Any) -> bool:
    return isinstance(tree, dict) and "g_params" in tree


def generator_variables(tree: Dict) -> Dict:
    """The generator's ``{'params', 'batch_stats', 'codebook'}`` from a
    variable tree or from a full train state (``{'params': g_params,
    **g_state}``, as the JAX package's ``load_generator_variables``)."""
    if is_train_state(tree):
        return {"params": tree["g_params"], **tree["g_state"]}
    return tree


def generator_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """Generator variables -> the port's state dict: a two-stream
    generator's (``rgb``/``op``), a single-stream UNet's
    (``inc``/``down1``/...) or a VQ-VAE net's (``enc_b``, or ``enc_b_1``
    for the two-stream one), told apart by the top-level params."""
    from .weights import (single_stream_state_from_jax, state_dict_from_jax,
                          vqvae_state_from_jax)

    top = set(variables["params"])
    if {"rgb", "op"} <= top:
        return state_dict_from_jax(variables)
    if {"inc", "outc"} <= top:
        return single_stream_state_from_jax(variables)
    if "enc_b" in top or "enc_b_1" in top:
        return vqvae_state_from_jax(variables)
    raise ValueError(f"generator params with top-level keys {sorted(top)}: "
                     "no generator of the port")


def net_config_of(variables: Dict):
    """The :class:`~..configs.NetConfig` whose generator these variables
    fill, from their shapes."""
    from ..configs import NetConfig

    params = variables["params"]

    def stream(p, cb):
        embed = np.shape(cb["vq_down3"]["quan"]["quantize"]["embed"])
        k = np.shape(p["vq_down3"]["quan"]["dec"]["kernel"])[2] // embed[0]
        return (np.shape(p["inc"]["conv0"]["kernel"])[2],
                np.shape(p["outc"]["kernel"])[3], embed, k)

    if "rgb" in params:
        rin, rout, embed, k = stream(params["rgb"], variables["codebook"]["rgb"])
        oin, oout, *_ = stream(params["op"], variables["codebook"]["op"])
        return NetConfig(net_tag="unet_vq_twostream", data_type="rgb_op",
                         in_channel=(rin, oin), out_channel=(rout, oout),
                         embed_dim=embed[0], n_embed=embed[1], k=k)
    cin, cout, embed, k = stream(params, variables["codebook"])
    return NetConfig(net_tag="unet_vq_topk_res",
                     data_type="rgb" if cout == 3 else "op",
                     in_channel=(cin, cin), out_channel=(cout, cout),
                     embed_dim=embed[0], n_embed=embed[1], k=k)


def _adam_state(opt_state: Any, what: str) -> Dict:
    """optax.adam's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``): the
    first element of its ``(scale_by_adam, scale_by_schedule)`` chain, or
    of the masked chain a ``--fix_branches`` run's generator takes (JAX
    ``train/optim.py:31-41``: ``optax.masked(adam)``, then
    ``optax.masked(set_to_zero)``), whose frozen subtrees of ``mu`` and
    ``nu`` are ``None``."""
    first = opt_state[0] if isinstance(opt_state, list) and opt_state else None
    if isinstance(first, dict) and "inner_state" in first:
        inner = first["inner_state"]
        first = inner[0] if isinstance(inner, list) and inner else None
    if isinstance(first, dict) and {"count", "mu", "nu"} <= set(first):
        return first
    raise ValueError(f"{what}: not optax.adam's state")


def trained_modules(adam: Dict) -> Dict[str, bool]:
    """Which top-level modules an Adam state trains (``g_mask``'s form):
    those whose moments it keeps."""
    return {k: v is not None for k, v in adam["mu"].items()}


def _adam_step_dtype() -> torch.dtype:
    # torch.optim.Adam keeps ``step`` as a CPU scalar of this dtype
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


@torch.no_grad()
def _load_adam(opt: torch.optim.Optimizer, module: torch.nn.Module,
               mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
               count: int, mask: Dict[str, bool]) -> None:
    """Put optax's moments (already in the port's names and layouts) into
    ``opt``'s state for each parameter of ``module`` that ``opt`` trains;
    ``mask`` (:func:`trained_modules`) must name the same modules."""
    trained = {id(p) for group in opt.param_groups for p in group["params"]}
    port = sorted({name.split(".")[0] for name, p in module.named_parameters()
                   if id(p) in trained})
    jax = sorted(k for k, on in mask.items() if on)
    if port != jax:
        raise ValueError(
            f"the JAX optimizer state trains {jax}, the port's optimizer "
            f"{port}: a --fix_branches run resumes with --fix_branches")
    if count == 0:
        return  # a fresh torch Adam holds no state either
    for name, p in module.named_parameters():
        if id(p) not in trained:
            continue
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=_adam_step_dtype()),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype)}


def restore_jax_train_state(tree: Dict, state) -> Any:
    """Fill a fresh port :class:`~..train.state.TrainState` (step 0, as
    ``create_train_state`` makes it) in place from the JAX training loop's
    full train state: generator and discriminator, both Adams' moments and
    counts, both schedulers stepped to the step.  Returns ``state``."""
    from .weights import discriminator_state_from_jax

    if state.step != 0 or state.g_sched.last_epoch != 0:
        raise ValueError("restore_jax_train_state fills a fresh train state")
    step = int(np.asarray(tree["step"]))
    g_vars = generator_variables(tree)
    state.generator.load_state_dict(generator_state_dict(g_vars))
    state.discriminator.load_state_dict(
        discriminator_state_from_jax(tree["d_params"]))
    g_adam = _adam_state(tree["g_opt_state"], "g_opt_state")
    d_adam = _adam_state(tree["d_opt_state"], "d_opt_state")

    def g_moment(m):
        # a frozen module's moments (None) take its weights' place: only
        # the trained modules' entries are read
        filled = {k: g_vars["params"][k] if v is None else v
                  for k, v in m.items()}
        return generator_state_dict({**g_vars, "params": filled})

    _load_adam(state.g_opt, state.generator, g_moment(g_adam["mu"]),
               g_moment(g_adam["nu"]), int(np.asarray(g_adam["count"])),
               trained_modules(g_adam))
    _load_adam(state.d_opt, state.discriminator,
               discriminator_state_from_jax(d_adam["mu"]),
               discriminator_state_from_jax(d_adam["nu"]),
               int(np.asarray(d_adam["count"])), trained_modules(d_adam))
    with warnings.catch_warnings():
        # "lr_scheduler.step() before optimizer.step()": the optimizers'
        # steps were taken by the JAX run
        warnings.simplefilter("ignore", UserWarning)
        for sched in (state.g_sched, state.d_sched):
            for _ in range(step):
                sched.step()
    state.step = step
    return state


def _run_optim_config(step_dir: str):
    """The :class:`~..configs.OptimConfig` of the run a step directory
    belongs to (``<run>/training/checkpoints/<step>``), else the defaults."""
    from ..configs import OptimConfig
    from ..utils.registry import CONFIG_FILENAME, load_run_config

    run_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(step_dir))))
    if os.path.isfile(os.path.join(run_dir, CONFIG_FILENAME)):
        return load_run_config(run_dir).optim
    return OptimConfig()


def train_state_from_jax(tree: Dict, optim=None):
    """A port TrainState on the CPU built for, and filled from, a JAX full
    train state (``optim``: the run's :class:`~..configs.OptimConfig`, whose
    learning rates and milestones the schedulers take)."""
    from ..configs import OptimConfig
    from ..models import build_model
    from ..train.state import create_train_state

    net = net_config_of(generator_variables(tree))
    model = build_model(net, mode="training", with_flow=False)
    mask = trained_modules(_adam_state(tree["g_opt_state"], "g_opt_state"))
    state = create_train_state(model.generator, model.discriminator,
                               optim or OptimConfig(), seed=0,
                               g_mask=None if all(mask.values()) else mask)
    return restore_jax_train_state(tree, state)


def convert(src: str, dst: str) -> str:
    """``src`` (``.msgpack`` or orbax step dir) -> a generator ``.pth`` at
    ``dst``, or for a full train state the port's step directory under
    ``dst``.  Returns the path written."""
    tree = read_jax_checkpoint(src)
    if is_train_state(tree):
        from ..train.checkpoint import save_checkpoint

        optim = (_run_optim_config(src) if os.path.isdir(src) else None)
        return save_checkpoint(dst, train_state_from_jax(tree, optim))
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(generator_state_dict(tree), dst)
    return dst


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="a JAX .msgpack file or orbax step directory")
    p.add_argument("dst", help="the generator .pth to write, or for a full "
                               "train state the checkpoint directory to "
                               "write <step:06d>/state.pt under")
    args = p.parse_args(argv)
    path = convert(args.src, args.dst)
    print(path)
    return path


if __name__ == "__main__":
    main()
