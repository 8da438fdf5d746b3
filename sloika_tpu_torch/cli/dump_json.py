"""Export a model to the JSON interchange format with the PyTorch port
(cf. ``sloika_tpu/cli/dump_json.py``, the reference's bin/dump_json.py)::

    python -m sloika_tpu_torch.cli.dump_json model.pkl --out_file model.json

Structure only, or structure and parameters; reads checkpoints (``.npz``),
model JSON and reference Theano pickles (``.pkl``).  The model is loaded
onto ``--device`` (default ``cuda``, which raises when no GPU is present)
and its parameters read back from there.
"""
import argparse
import json
import sys

from sloika_tpu_torch import __version__
from sloika_tpu_torch.cmdargs import (AutoBool, FileExists,
                                      display_version_and_exit)


def make_parser():
    parser = argparse.ArgumentParser(
        description='Dump JSON representation of a model (PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--device', default='cuda',
                        help='Torch device to load the model onto')
    parser.add_argument('--params', default=True, action=AutoBool,
                        help='Include parameters in the dump')
    parser.add_argument('--out_file', default=None,
                        help='Output file (default stdout)')
    parser.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    parser.add_argument('model', action=FileExists,
                        help='Checkpoint (.npz), model JSON or reference .pkl')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    from sloika_tpu_torch import config
    from sloika_tpu_torch.cli.basecall import load_model

    dev = config.resolve_device(args.device)
    obj = load_model(args.model).to(dev).to_json(args.params)
    out = open(args.out_file, 'w') if args.out_file else sys.stdout
    try:
        json.dump(obj, out, indent=2)
        out.write('\n')
    finally:
        if args.out_file:
            out.close()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
