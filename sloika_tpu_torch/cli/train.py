"""Train a network with the PyTorch port (cf. ``sloika_tpu/cli/train.py``).

Subcommands ``raw`` and ``events``::

    python -m sloika_tpu_torch.cli.train raw raw_0.98_rgrgr out/ chunks.hdf5 \\
        --device cuda
    python -m sloika_tpu_torch.cli.train events baseline_lstm out/ \\
        event_chunks.hdf5 --device cuda

The model is a registered name of :mod:`sloika_tpu_torch.models`, a
``.py`` model file (copied into the output directory as ``model.py``), or a
``.npz`` checkpoint of either package to resume, optimiser state included.
``--device cuda`` raises when no GPU is present.  ``--steps_per_dispatch
k`` runs k optimiser steps a group (one CUDA graph replay on the card; a
fixed chunk length, ``--chunk_len_range x x``), ``--data_on_device`` keeps
the chunk set on the device for such groups, ``--profile dir`` writes a
``torch.profiler`` Chrome trace.

``--ndevice N`` trains data-parallel over N ranks, one a device
(:mod:`sloika_tpu_torch.parallel`; default: every visible card, or one
rank on the CPU): the command starts the N ranks itself, or, under
``torchrun``, checks N against the launcher's ``WORLD_SIZE``.  Only rank 0
writes the output directory::

    python -m sloika_tpu_torch.cli.train raw raw_0.98_rgrgr out/ \
        chunks.hdf5 --ndevice 2
    torchrun --nproc_per_node 4 -m sloika_tpu_torch.cli.train raw \
        raw_0.98_rgrgr out/ chunks.hdf5 --ndevice 4
"""
import argparse
import os
import shutil
import sys

from sloika_tpu_torch import __version__
from sloika_tpu_torch.cmdargs import (AutoBool, FileExists, Maybe, NonNegative,
                                ParseToNamedTuple, Positive, proportion,
                                display_version_and_exit)


def make_parser():
    parser = argparse.ArgumentParser(
        description='Train a transducer neural network (PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--adam', nargs=3, metavar=('rate', 'decay1', 'decay2'),
                        default=(1e-3, 0.9, 0.999),
                        type=(NonNegative(float), NonNegative(float),
                              NonNegative(float)),
                        action=ParseToNamedTuple,
                        help='Parameters for ADAMski optimiser')
    common.add_argument('--bad', default=True, action=AutoBool,
                        help='Force blocks marked as bad to be stays')
    common.add_argument('--batch_size', default=100, metavar='chunks',
                        type=Positive(int),
                        help='Number of chunks to run in parallel')
    common.add_argument('--chunk_len_range', nargs=2, metavar=('min', 'max'),
                        type=Maybe(proportion), default=(0.5, 1.0),
                        help='Sample chunk sizes between min and max '
                             '(fraction of chunk size in input file)')
    common.add_argument('--device', default='cuda',
                        help='Torch device to train on')
    common.add_argument('--ilf', default=False, action=AutoBool,
                        help='Weight objective by inverse label frequency')
    common.add_argument('--l2', default=0.0, metavar='penalty',
                        type=NonNegative(float), help='L2 penalty on parameters')
    common.add_argument('--ndevice', default=None, type=Positive(int),
                        help='Number of devices (ranks) for data '
                             'parallelism (default: all)')
    common.add_argument('--lrdecay', default=5000, metavar='n',
                        type=Positive(float),
                        help='LR for batch i is adam.rate / (1.0 + i / n)')
    common.add_argument('--lr_warmup', default=0, metavar='n',
                        type=NonNegative(int),
                        help='Run the first n iterations at lr 0')
    common.add_argument('--min_prob', default=1e-30, metavar='p',
                        type=proportion, help='Minimum probability in training')
    common.add_argument('--niteration', metavar='batches', type=Positive(int),
                        default=50000, help='Maximum number of batches')
    common.add_argument('--optimiser', default='adamski',
                        choices=['adamski', 'adam', 'sgd'],
                        help='adamski, plain adam, or momentum SGD (--adam '
                             'decay1 is the momentum)')
    common.add_argument('--overwrite', default=False, action=AutoBool,
                        help='Overwrite output directory')
    common.add_argument('--quiet', default=False, action=AutoBool,
                        help="Don't print progress to stdout")
    common.add_argument('--reweight', metavar='group', default='weights',
                        type=Maybe(str),
                        help="Select chunks according to weights in 'group'")
    common.add_argument('--save_every', metavar='x', type=Positive(int),
                        default=5000, help='Save model every x batches')
    common.add_argument('--sd', default=0.5, metavar='value',
                        type=Positive(float),
                        help='Standard deviation for initialisation')
    common.add_argument('--seed', default=None, metavar='integer',
                        type=Positive(int), help='Random number seed')
    common.add_argument('--steps_per_dispatch', metavar='k',
                        type=Positive(int), default=1,
                        help='Fuse k optimiser steps a group, one CUDA '
                             'graph replay on the card (fixed chunk length '
                             'only; identical maths)')
    common.add_argument('--data_on_device', default='auto',
                        choices=('auto', 'on', 'off'),
                        help='Keep the whole chunk set resident in device '
                             'memory and gather batches there (the host '
                             'ships sampler indices only; bit-identical '
                             'training).  auto = on when '
                             '--steps_per_dispatch > 1 and the set fits '
                             'SLOIKA_TPU_RESIDENT_BYTES (1.2 GB)')
    common.add_argument('--profile', default=None, metavar='dir',
                        help='Write a torch.profiler Chrome trace of the '
                             'steady steps under dir')
    common.add_argument('--smooth', default=0.45, metavar='factor',
                        type=proportion, help='Progress smoothing factor')
    common.add_argument('--transducer', default=True, action=AutoBool,
                        help='Train a transducer model')
    common.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    common.add_argument('model',
                        help='Model name, python model file, or checkpoint '
                             '(.npz) to resume')
    common.add_argument('output', help='Output directory')
    common.add_argument('input', action=FileExists,
                        help='HDF5 file containing chunks')

    sub = parser.add_subparsers(dest='command', required=True)
    pe = sub.add_parser('events', parents=[common], help='Train from events',
                        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    pe.add_argument('--drop', default=20, metavar='events',
                    type=NonNegative(int),
                    help='Drop events at chunk edges from the loss')
    pe.add_argument('--winlen', default=3, type=Positive(int),
                    help='Length of window over data')
    raw = sub.add_parser('raw', parents=[common], help='Train from raw signal',
                         formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    raw.add_argument('--drop', default=20, metavar='samples',
                     type=NonNegative(int),
                     help='Drop labels at chunk edges from the loss')
    raw.add_argument('--winlen', default=11, type=Positive(int),
                     help='Length of window over data')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)

    import numpy as np
    from sloika_tpu_torch import config, serialize, training
    from sloika_tpu_torch.data import hdf5
    from sloika_tpu_torch.models import network_factory
    from sloika_tpu_torch.parallel import mesh
    from sloika_tpu_torch.variables import DEFAULT_ALPHABET

    code = mesh.launch(main, argv, args.ndevice, args.device)
    if code is not None:            # the ranks this command started
        return code
    dev = mesh.local_device(args.device)
    config.disable_tf32()
    lead = mesh.rank() == 0
    clash = lead and os.path.exists(args.output) and not args.overwrite
    if mesh.agree(clash):
        if lead:
            sys.stderr.write('Error: Output directory {} exists but '
                             '--overwrite is false\n'.format(args.output))
        return 1
    if lead:
        os.makedirs(args.output, exist_ok=True)

    log = training.Logger(
        os.path.join(args.output, 'model.log') if lead else None,
        args.quiet or not lead)
    try:
        log.write('* Command line\n' + ' '.join(sys.argv) + '\n')
        log.write('* Loading data from {}\n'.format(args.input))
        data = hdf5.load_labelled_chunks(args.input, reweight=args.reweight)
        stride = int(np.ceil(float(data['chunks'].shape[1])
                             / data['labels'].shape[1]))
        klen = int(data['attrs'].get('kmer', 5))
        alphabet = data['attrs'].get('alphabet', DEFAULT_ALPHABET)
        if isinstance(alphabet, str):
            alphabet = alphabet.encode('utf-8')
        log.write('* Device: {}\n'.format(mesh.describe(dev)))

        opt_state = None
        if args.model.endswith('.npz'):
            log.write('* Resuming from checkpoint {}\n'.format(args.model))
            layer, _, opt_state = serialize.load_checkpoint(args.model)
        else:
            log.write('* Building network {}\n'.format(args.model))
            if (lead and args.model.endswith('.py')
                    and os.path.exists(args.model)):
                shutil.copyfile(args.model,
                                os.path.join(args.output, 'model.py'))
            layer = network_factory(args.model)(
                klen=klen, sd=args.sd, nbase=len(alphabet),
                nfeature=data['chunks'].shape[-1], winlen=args.winlen,
                stride=stride, seed=args.seed or 0)

        training.train(
            layer, data, output=args.output,
            adam=(args.adam.rate, args.adam.decay1, args.adam.decay2),
            batch_size=args.batch_size, chunk_len_range=args.chunk_len_range,
            drop=args.drop, ilf=args.ilf, l2=args.l2, lrdecay=args.lrdecay,
            min_prob=args.min_prob, niteration=args.niteration,
            save_every=args.save_every, seed=args.seed, smooth=args.smooth,
            transducer=args.transducer, bad=args.bad, log=log,
            opt_state=opt_state, optimiser=args.optimiser,
            lr_warmup=args.lr_warmup, profile_dir=args.profile,
            steps_per_dispatch=args.steps_per_dispatch,
            data_on_device={"auto": "auto", "on": True,
                            "off": False}[args.data_on_device],
            device=dev)
    finally:
        log.close()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
