"""Prepare labelled training chunks with the PyTorch port
(cf. ``sloika_tpu/cli/chunkify.py``).

Only the ``raw_remap`` subcommand is ported: raw reads are remapped against
per-read references with a model on the device, then chunked::

    python -m sloika_tpu_torch.cli.chunkify raw_remap reads/ chunks.hdf5 \\
        model.json refs.fa --dac --device cuda

``--device cuda`` raises when no GPU is present.  Not ported (see ROADMAP):
the ``identity``, ``remap`` and ``raw_identity`` subcommands and
``--devices``.
"""
import argparse

from sloika_tpu_torch import __version__
from sloika_tpu_torch.cmdargs import (AutoBool, ByteString, FileExists, Maybe,
                                      NonNegative, Positive, proportion,
                                      display_version_and_exit)


def proportion_percent(argument):
    """Percentage in [0, 100] (sloika_tpu/cli/chunkify.py:138)."""
    val = float(argument)
    if not 0.0 <= val <= 100.0:
        raise argparse.ArgumentTypeError(
            '{} must be in [0, 100]'.format(val))
    return val


def make_parser():
    parser = argparse.ArgumentParser(
        description='Prepare labelled training chunks from fast5 reads '
                    '(PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = parser.add_subparsers(dest='command', required=True)
    p = sub.add_parser('raw_remap',
                       help='Remap raw reads to references then chunk',
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument('--alphabet', default=b'ACGT', type=ByteString,
                   help='Alphabet of the model')
    p.add_argument('--band', default='auto',
                   help='Remap DP band width in sequence positions: "auto" '
                        '(768 on CUDA, exact on the CPU), "exact", or an '
                        'integer')
    p.add_argument('--batch', default=64, type=Positive(int),
                   help='Reads remapped per device batch')
    p.add_argument('--blanks_percentile', metavar='percentage', default=95,
                   type=proportion_percent,
                   help='Percentile of blank fractions above which chunks '
                        'get zero weight')
    p.add_argument('--chunk_len', default=2000, type=Positive(int),
                   help='Samples per chunk')
    p.add_argument('--dac', default=False, action=AutoBool,
                   help='Ship raw int16 DAC samples and normalise on the '
                        'device. Signal values differ from the host loader '
                        'by <=2 ulp of f32 scaling')
    p.add_argument('--device', default='cuda',
                   help='Torch device to remap on')
    p.add_argument('--downsample_factor', default=1, type=Positive(int),
                   help='Factor by which to downsample labels')
    p.add_argument('--input_strand_list', default=None, action=FileExists,
                   help='Strand list restricting reads')
    p.add_argument('--interpolation', default=False, action=AutoBool,
                   help='Interpolate sequence positions between mapped '
                        'locations')
    p.add_argument('--jobs', default=8, metavar='n', type=Positive(int),
                   help='Host threads for read loading')
    p.add_argument('--kmer_len', default=5, type=Positive(int),
                   help='Length of kmer labels')
    p.add_argument('--limit', default=None, type=Maybe(Positive(int)),
                   help='Limit number of reads')
    p.add_argument('--min_length', default=2500, type=Positive(int),
                   help='Minimum samples in acceptable read')
    p.add_argument('--min_prob', default=1e-5, type=proportion,
                   help='Posterior probability floor')
    p.add_argument('--normalisation', default='per-read',
                   choices=['none', 'per-read', 'per-chunk'])
    p.add_argument('--open_pore_fraction', default=0.3, type=proportion,
                   help='Max fraction of signal to trim as open pore')
    p.add_argument('--output_strand_list', default='strand_output_list.txt',
                   help='Strand summary output file')
    p.add_argument('--overwrite', default=False, action=AutoBool,
                   help='Overwrite output files')
    p.add_argument('--prior', nargs=2, metavar=('start', 'end'),
                   default=(25.0, 25.0), type=Maybe(NonNegative(float)),
                   help='Mean of geometric start/end position priors')
    p.add_argument('--slip', default=5.0, type=NonNegative(float),
                   help='Slip penalty')
    p.add_argument('--trim', default=(200, 50), nargs=2,
                   type=NonNegative(int), metavar=('beginning', 'end'),
                   help='Samples to trim from read ends')
    p.add_argument('--version', nargs=0,
                   action=display_version_and_exit(__version__),
                   help='Display version')
    p.add_argument('input_folder', action=FileExists,
                   help='Directory containing fast5 files')
    p.add_argument('output', help='Output HDF5 file')
    p.add_argument('model', action=FileExists,
                   help='Model for remapping (.npz checkpoint, .json '
                        'or reference .pkl)')
    p.add_argument('references', action=FileExists,
                   help='FASTA of per-read references')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    from sloika_tpu_torch.data import chunkify_tools
    chunkify_tools.raw_chunkify_with_remap_main(args)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
