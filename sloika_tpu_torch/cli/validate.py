"""Held-out evaluation with the PyTorch port
(cf. ``sloika_tpu/cli/validate.py``)::

    python -m sloika_tpu_torch.cli.validate model_final.npz chunks.hdf5 \\
        --device cuda
"""
import argparse

from sloika_tpu_torch import __version__
from sloika_tpu.cmdargs import (AutoBool, FileExists, Maybe, Positive,
                                proportion, display_version_and_exit)


def make_parser():
    parser = argparse.ArgumentParser(
        description='Validate a model against held-out chunks '
                    '(PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--bad', default=True, action=AutoBool,
                        help='Force blocks marked as bad to be stays')
    parser.add_argument('--batch_size', default=200, metavar='chunks',
                        type=Positive(int), help='Chunks per batch')
    parser.add_argument('--device', default='cuda',
                        help='Torch device to run on')
    parser.add_argument('--drop', default=0, type=int,
                        help='Drop positions at chunk edges from the loss')
    parser.add_argument('--min_prob', default=1e-30, type=proportion,
                        help='Minimum probability')
    parser.add_argument('--reweight', metavar='group', default='weights',
                        type=Maybe(str), help='Chunk weight group')
    parser.add_argument('--transducer', default=True, action=AutoBool,
                        help='Model is a transducer')
    parser.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    parser.add_argument('model', action=FileExists,
                        help='Checkpoint (.npz) or model JSON')
    parser.add_argument('input', action=FileExists,
                        help='HDF5 file containing chunks')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)

    from sloika_tpu_torch import config, training
    from sloika_tpu_torch.cli.basecall import load_model
    from sloika_tpu_torch.data import hdf5

    dev = config.resolve_device(args.device)
    config.disable_tf32()
    layer = load_model(args.model)
    data = hdf5.load_labelled_chunks(args.input, reweight=args.reweight)
    loss, acc = training.validate(
        layer, data, batch_size=args.batch_size, min_prob=args.min_prob,
        drop=args.drop, transducer=args.transducer, bad=args.bad,
        device=dev)
    print('loss {:.4f}  accuracy {:.2f}%'.format(loss, 100.0 * acc))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
