"""Convert a model between formats with the PyTorch port
(cf. ``sloika_tpu/cli/model_convert.py``)::

    python -m sloika_tpu_torch.cli.model_convert model.pkl model.npz

Reads a reference Theano pickle (``.pkl``), a model JSON or a checkpoint
(``.npz``) and writes a model JSON or a checkpoint, by the output's
extension, in the format both packages read.  The model passes through
``--device`` (default ``cuda``, which raises when no GPU is present).
"""
import argparse

from sloika_tpu_torch.cmdargs import FileExists


def make_parser():
    parser = argparse.ArgumentParser(
        description='Convert a model between .pkl/.json/.npz formats '
                    '(PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--device', default='cuda',
                        help='Torch device to load the model onto')
    parser.add_argument('input', action=FileExists,
                        help='Input model (.pkl reference pickle, .json '
                             'interchange dump, or .npz checkpoint)')
    parser.add_argument('output',
                        help='Output model (.json or .npz by extension)')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    if not args.output.endswith(('.json', '.npz')):
        raise SystemExit('Output must end in .json or .npz')
    from sloika_tpu_torch import config, serialize
    from sloika_tpu_torch.cli.basecall import load_model

    dev = config.resolve_device(args.device)
    layer = load_model(args.input).to(dev)
    if args.output.endswith('.json'):
        serialize.save_model_json(args.output, layer)
    else:
        serialize.save_checkpoint(args.output, layer)
    print('Wrote {} ({} parameters)'.format(
        args.output, sum(p.numel() for p in layer.parameters())))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
