"""Basecall reads with the PyTorch port (cf. ``sloika_tpu/cli/basecall.py``).

Two subcommands::

    python -m sloika_tpu_torch.cli.basecall raw model.npz reads/ \\
        --device cuda --output calls.fa
    python -m sloika_tpu_torch.cli.basecall events model.npz reads/ \\
        --device cuda --output calls.fa

Both decode as the JAX package does by default: whole reads in batches of
``--batch``, in order of length (``--no-chunked``), ``raw`` from signals
normalised on the host (``--trim``, ``--open_pore_fraction``), ``events``
from event features (``--section``, ``--trim``).  With ``--chunked`` they
run the chunked "bases" mode: ``raw`` ships int16 DAC samples and windows
and normalises them on the device, ``events`` windows the feature
matrices.
FASTA goes to stdout unless ``--output`` is given.  ``--device cuda``
raises when no GPU is present.
"""
import argparse
import sys
import time

from sloika_tpu_torch import __version__
from sloika_tpu_torch.cmdargs import (AutoBool, FileExists, Maybe, NonNegative,
                                      Positive, proportion,
                                      display_version_and_exit)
from sloika_tpu_torch.data.fast5 import iterate_fast5


def make_parser():
    parser = argparse.ArgumentParser(
        description='Basecall reads with a transducer network (PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--batch', default=8, metavar='n',
                        type=Positive(int),
                        help='Windows (chunked) or reads per device batch')
    common.add_argument('--chunked', default=False, action=AutoBool,
                        help='Chunked overlap-stitch decoding (exact '
                             'full-read decode when disabled)')
    common.add_argument('--chunk_size', default=8192, type=Positive(int),
                        help='Window size for chunked decoding')
    common.add_argument('--device', default='cuda',
                        help='Torch device to run on')
    common.add_argument('--overlap', default=400, type=Positive(int),
                        help='Window overlap for chunked decoding')
    common.add_argument('--kmer_len', default=5, type=Positive(int),
                        help='Kmer length of model')
    common.add_argument('--limit', default=None, type=Maybe(Positive(int)),
                        help='Limit number of reads processed')
    common.add_argument('--min_prob', default=1e-5, type=proportion,
                        help='Minimum posterior probability')
    common.add_argument('--skip', default=5.0, type=NonNegative(float),
                        help='Skip penalty for transducer decoding')
    common.add_argument('--strand_list', default=None, action=FileExists,
                        help='File containing reads to process')
    common.add_argument('--output', default=None,
                        help='Output FASTA file (default stdout)')
    common.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    common.add_argument('model', action=FileExists,
                        help='Checkpoint (.npz) or model JSON')
    common.add_argument('input_folder', action=FileExists,
                        help='Directory containing fast5 files')

    sub = parser.add_subparsers(dest='command', required=True)
    ev = sub.add_parser('events', parents=[common],
                        help='Basecall from events',
                        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ev.add_argument('--section', default='template',
                    choices=['template', 'complement'])
    ev.add_argument('--segmentation', default='Segmentation',
                    help='Segmentation analysis name')
    ev.add_argument('--trim', default=(50, 10), nargs=2,
                    type=NonNegative(int), metavar=('beginning', 'end'),
                    help='Events to trim')
    raw = sub.add_parser('raw', parents=[common],
                         help='Basecall from raw signal',
                         formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    raw.add_argument('--open_pore_fraction', default=0.3, type=proportion,
                     help='Max fraction of signal to trim as open pore')
    raw.add_argument('--trim', default=(200, 50), nargs=2,
                     type=NonNegative(int), metavar=('beginning', 'end'),
                     help='Samples to trim')
    return parser


def load_model(path):
    """Load a layer (holding its parameters) from a checkpoint or JSON."""
    from sloika_tpu_torch import serialize
    if path.endswith('.npz'):
        return serialize.load_checkpoint(path)[0]
    if path.endswith('.json'):
        layer, params = serialize.load_model_json(path)
        if params is None:
            raise ValueError('model JSON has no parameters')
        return layer
    raise ValueError('model must be a .npz checkpoint or a .json model')


def main(argv=None):
    args = make_parser().parse_args(argv)
    events = args.command == 'events'
    from sloika_tpu_torch import basecall as bc

    output = 'bases' if args.chunked else 'states'
    caller = bc.Basecaller(load_model(args.model), args.kmer_len,
                           min_prob=args.min_prob, skip=args.skip,
                           batch_size=args.batch, chunk_size=args.chunk_size,
                           overlap=args.overlap, output=output,
                           device=args.device)
    datatype = 'events' if events else 'samples'
    printer = bc.SeqPrinter(datatype=datatype, fname=args.output,
                            kmer_len=args.kmer_len)
    write = printer.write_codes if output == 'bases' else printer.write
    files = iterate_fast5(args.input_folder, strand_list=args.strand_list,
                          limit=args.limit)
    if events:
        load = lambda fn: bc.load_event_features(
            fn, section=args.section, segmentation=args.segmentation,
            trim=tuple(args.trim))
    elif output == 'states':
        load = lambda fn: bc.load_raw_signal(
            fn, trim=tuple(args.trim),
            open_pore_fraction=args.open_pore_fraction)
    else:
        load = lambda fn: bc.load_raw_dac(
            fn, trim=tuple(args.trim),
            open_pore_fraction=args.open_pore_fraction)

    t0 = time.time()
    nbases = nsignal = nreads = 0
    # bounded blocks keep host memory O(block)
    block = max(8 * args.batch, 512)
    try:
        for lo in range(0, len(files), block):
            loaded = [r for r in map(load, files[lo:lo + block])
                      if r is not None]
            if not loaded:
                continue
            if output == 'states' or events:
                results = caller.basecall_signals([r[1] for r in loaded])
            else:
                results = caller.basecall_dac_reads(
                    [(r[1], r[2]) for r in loaded])
            for r, (score, call) in zip(loaded, results):
                nbases += write(r[0], score, call, len(r[1]))
                nsignal += len(r[1])
                nreads += 1
    finally:
        printer.close()
    dt = time.time() - t0
    sys.stderr.write(
        'Called {} reads in {:.2f}s ({:.1f} bases/s, {:.1f} {}/s)\n'
        .format(nreads, dt, nbases / dt, nsignal / dt, datatype))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
