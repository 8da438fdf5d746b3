"""Basecall raw reads with the PyTorch port
(cf. ``sloika_tpu/cli/basecall.py``).

Only the ``raw`` subcommand is ported, in chunked "bases" mode from int16
DAC samples::

    python -m sloika_tpu_torch.cli.basecall raw model.npz reads/ --chunked \\
        --device cuda --output calls.fa

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
    sub = parser.add_subparsers(dest='command', required=True)
    raw = sub.add_parser('raw', help='Basecall from raw signal',
                        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    raw.add_argument('--batch', default=8, metavar='windows',
                    type=Positive(int), help='Windows per device batch')
    raw.add_argument('--chunked', default=True, action=AutoBool,
                    help='Chunked overlap-stitch decoding (the only ported '
                         'mode)')
    raw.add_argument('--chunk_size', default=8192, type=Positive(int),
                    help='Window size for chunked decoding (samples)')
    raw.add_argument('--device', default='cuda',
                    help='Torch device to run on')
    raw.add_argument('--overlap', default=400, type=Positive(int),
                    help='Window overlap for chunked decoding (samples)')
    raw.add_argument('--kmer_len', default=5, type=Positive(int),
                    help='Kmer length of model')
    raw.add_argument('--limit', default=None, type=Maybe(Positive(int)),
                    help='Limit number of reads processed')
    raw.add_argument('--min_prob', default=1e-5, type=proportion,
                    help='Minimum posterior probability')
    raw.add_argument('--skip', default=5.0, type=NonNegative(float),
                    help='Skip penalty for transducer decoding')
    raw.add_argument('--strand_list', default=None, action=FileExists,
                    help='File containing reads to process')
    raw.add_argument('--output', default=None,
                    help='Output FASTA file (default stdout)')
    raw.add_argument('--open_pore_fraction', default=0.3, type=proportion,
                    help='Max fraction of signal to trim as open pore')
    raw.add_argument('--trim', default=(200, 50), nargs=2,
                    type=NonNegative(int), metavar=('beginning', 'end'),
                    help='Samples to trim')
    raw.add_argument('--version', nargs=0,
                    action=display_version_and_exit(__version__),
                    help='Display version')
    raw.add_argument('model', action=FileExists,
                    help='Checkpoint (.npz) or model JSON')
    raw.add_argument('input_folder', action=FileExists,
                    help='Directory containing fast5 files')
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
    if not args.chunked:
        raise NotImplementedError('exact per-read decoding is not ported; '
                                  'use --chunked')
    from sloika_tpu_torch import basecall as bc

    caller = bc.Basecaller(load_model(args.model), args.kmer_len,
                           min_prob=args.min_prob, skip=args.skip,
                           batch_size=args.batch, chunk_size=args.chunk_size,
                           overlap=args.overlap, device=args.device)
    printer = bc.SeqPrinter(datatype='samples', fname=args.output)
    files = iterate_fast5(args.input_folder, strand_list=args.strand_list,
                          limit=args.limit)

    t0 = time.time()
    nbases = nsamples = nreads = 0
    # bounded blocks keep host memory O(block)
    block = max(8 * args.batch, 512)
    try:
        for lo in range(0, len(files), block):
            loaded = [bc.load_raw_dac(
                fn, trim=tuple(args.trim),
                open_pore_fraction=args.open_pore_fraction)
                for fn in files[lo:lo + block]]
            loaded = [r for r in loaded if r is not None]
            if not loaded:
                continue
            results = caller.basecall_dac_reads([(r[1], r[2]) for r in loaded])
            for (name, dac, _), (score, codes) in zip(loaded, results):
                nbases += printer.write_codes(name, score, codes, len(dac))
                nsamples += len(dac)
                nreads += 1
    finally:
        printer.close()
    dt = time.time() - t0
    sys.stderr.write(
        'Called {} reads in {:.2f}s ({:.1f} bases/s, {:.1f} samples/s)\n'
        .format(nreads, dt, nbases / dt, nsamples / dt))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
