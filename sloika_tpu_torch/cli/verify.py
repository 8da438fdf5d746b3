"""Smoke-test a model with the PyTorch port (cf. ``sloika_tpu/cli/verify.py``,
the reference's bin/verify_network.py)::

    python -m sloika_tpu_torch.cli.verify bigger_raw_gru --stride 2 \\
        --device cuda

Builds a registered model or a ``.py`` model file from seed 0, runs a few
batches of random shapes through it (inputs from a seeded
``torch.Generator`` on the device) and checks that every output is finite.
``--device cuda`` raises when no GPU is present.
"""
import argparse

from sloika_tpu_torch import __version__
from sloika_tpu_torch.cmdargs import Positive, display_version_and_exit


def make_parser():
    parser = argparse.ArgumentParser(
        description='Verify a model file builds and runs (PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--device', default='cuda',
                        help='Torch device to run on')
    parser.add_argument('--kmer_len', default=5, type=Positive(int))
    parser.add_argument('--nfeature', default=1, type=Positive(int))
    parser.add_argument('--winlen', default=11, type=Positive(int))
    parser.add_argument('--stride', default=1, type=Positive(int))
    parser.add_argument('--sd', default=0.5, type=float)
    parser.add_argument('--nbatch', default=5, type=Positive(int),
                        help='Number of random-shaped batches to run')
    parser.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    parser.add_argument('model', help='Model name or python file')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)

    import numpy as np
    import torch
    from sloika_tpu_torch import config
    from sloika_tpu_torch.models import network_factory

    dev = config.resolve_device(args.device)
    config.disable_tf32()
    layer = network_factory(args.model)(
        klen=args.kmer_len, sd=args.sd, nfeature=args.nfeature,
        winlen=args.winlen, stride=args.stride, seed=0).to(dev).eval()
    nparam = sum(p.numel() for p in layer.parameters())
    print('* Built network: insize {}, size {}, {} parameters'.format(
        layer.insize, layer.size, nparam))

    # the shapes are the JAX package's; the inputs are drawn on the device
    rs = np.random.RandomState(17)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    with torch.inference_mode():
        for i in range(args.nbatch):
            ntime = int(rs.randint(50, 500)) // args.stride * args.stride
            nbatch = int(rs.randint(1, 17))
            x = torch.randn((ntime, nbatch, args.nfeature), generator=gen,
                            device=dev)
            out = layer(x)
            if not bool(torch.isfinite(out).all()):
                raise ValueError('non-finite output in batch {}'.format(i))
            print('  batch {}: in ({}, {}, {}) -> out {}'.format(
                i, ntime, nbatch, args.nfeature, tuple(out.shape)))
    print('* OK')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
