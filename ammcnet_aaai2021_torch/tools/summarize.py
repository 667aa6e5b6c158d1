"""Model summaries: parameter counts by module for every net_tag.

Port of ``ammcnet_aaai2021_tpu/tools/summarize.py`` (itself a rebuild of
the reference's torchsummaryX harnesses): builds the tag in float32, runs
one forward of zeros at ``--image_size`` on ``--device``, and prints a table
of (module path, params) plus the total and the count of the non-parameter
state (BatchNorm statistics and codebooks; BatchNorm's
``num_batches_tracked``, which flax does not keep, is left out), which equal
the JAX package's.

  python -m ammcnet_aaai2021_torch.tools.summarize --net_tag vqvae_twostream
  python -m ammcnet_aaai2021_torch.tools.summarize --device cpu
"""

from __future__ import annotations

import argparse

import torch


def summarize(net_tag: str = "unet_vq_twostream", image_size: int = 64,
              depth: int = 2, device: str = "cuda") -> int:
    """Print the table for ``net_tag`` and return its parameter total."""
    from ..configs import NetConfig
    from ..models import TWO_STREAM_TAGS, build_generator, init_weights

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is visible "
                           "(pass --device cpu to summarize on the CPU)")
    cfg = NetConfig(net_tag=net_tag, dtype="float32")
    gen = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    gen = gen.to(dev).eval()
    s = image_size
    inputs = [torch.zeros(1, cfg.in_channel[0], s, s, device=dev)]
    if net_tag in TWO_STREAM_TAGS:
        inputs.append(torch.zeros(1, cfg.in_channel[1], s, s, device=dev))
    with torch.no_grad():
        gen(*inputs)

    rows = {}
    for name, p in gen.named_parameters():
        group = "/".join(name.split(".")[:depth])
        rows[group] = rows.get(group, 0) + p.numel()
    total = sum(rows.values())
    width = max(len(k) for k in rows) + 2
    print(f"net_tag: {net_tag}")
    for group in sorted(rows):
        print(f"  {group:<{width}} {rows[group]:>12,}")
    print(f"  {'TOTAL (params)':<{width}} {total:>12,}")
    n_state = sum(b.numel() for name, b in gen.named_buffers()
                  if not name.endswith("num_batches_tracked"))
    print(f"  {'non-param state':<{width}} {n_state:>12,}")
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--net_tag", default="unet_vq_twostream")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device of the forward; 'cuda' fails when no "
                        "GPU is visible")
    args = p.parse_args(argv)
    return summarize(args.net_tag, args.image_size, args.depth, args.device)


if __name__ == "__main__":
    main()
