"""Prepare labelled training chunks with the PyTorch port
(cf. ``sloika_tpu/cli/chunkify.py``): the subcommands ``identity`` and
``raw_identity`` chunk event or raw reads by the mapping tables in their
files; ``remap`` and ``raw_remap`` first remap the reads against per-read
references with a model on the device::

    python -m sloika_tpu_torch.cli.chunkify raw_remap reads/ chunks.hdf5 \\
        model.json refs.fa --dac --device cuda
    python -m sloika_tpu_torch.cli.chunkify remap reads/ chunks.hdf5 \\
        model.json refs.fa --device cuda

``--device cuda`` raises when no GPU is present.  Every flag takes the JAX
CLI's default and type.

``--devices N`` (the remap subcommands) remaps over N ranks, one a device
(:mod:`sloika_tpu_torch.parallel`): the command starts them itself, or,
under ``torchrun``, checks N against the launcher's ``WORLD_SIZE``.  Each
rank chunks a strided share of the reads, and rank 0 writes the HDF5 and
the strand list in the order of a single process.  ``identity`` and
``raw_identity`` share their reads the same way over the ranks of a
launcher::

    python -m sloika_tpu_torch.cli.chunkify raw_remap reads/ chunks.hdf5 \
        model.json refs.fa --devices 2
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
    """The JAX parser's structure (sloika_tpu/cli/chunkify.py:13-127): the
    parents ``common``, ``ev_common``, ``raw_common`` and ``remap_common``
    (with the port's ``--device``)."""
    parser = argparse.ArgumentParser(
        description='Prepare labelled training chunks from fast5 reads '
                    '(PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--alphabet', default=b'ACGT', type=ByteString,
                        help='Alphabet of the model')
    common.add_argument('--blanks_percentile', metavar='percentage',
                        default=95, type=proportion_percent,
                        help='Percentile of blank fractions above which '
                             'chunks get zero weight')
    common.add_argument('--input_strand_list', default=None,
                        action=FileExists, help='Strand list restricting reads')
    common.add_argument('--jobs', default=8, metavar='n', type=Positive(int),
                        help='Host threads for read loading')
    common.add_argument('--kmer_len', default=5, type=Positive(int),
                        help='Length of kmer labels')
    common.add_argument('--limit', default=None, type=Maybe(Positive(int)),
                        help='Limit number of reads')
    common.add_argument('--overwrite', default=False, action=AutoBool,
                        help='Overwrite output files')
    common.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    common.add_argument('input_folder', action=FileExists,
                        help='Directory containing fast5 files')
    common.add_argument('output', help='Output HDF5 file')

    ev_common = argparse.ArgumentParser(add_help=False)
    ev_common.add_argument('--chunk_len', default=500, type=Positive(int),
                           help='Events per chunk')
    ev_common.add_argument('--min_length', default=1200, type=Positive(int),
                           help='Minimum events in acceptable read')
    ev_common.add_argument('--normalisation', default='per-read',
                           choices=['none', 'per-read', 'per-chunk'])
    ev_common.add_argument('--section', default='template',
                           choices=['template', 'complement'])
    ev_common.add_argument('--trim', default=(50, 10), nargs=2,
                           type=NonNegative(int), metavar=('beginning', 'end'),
                           help='Events to trim from read ends')
    ev_common.add_argument('--use_scaled', default=False, action=AutoBool,
                           help='Use prescaled event statistics')

    raw_common = argparse.ArgumentParser(add_help=False)
    raw_common.add_argument('--chunk_len', default=2000, type=Positive(int),
                            help='Samples per chunk')
    raw_common.add_argument('--downsample_factor', default=1,
                            type=Positive(int),
                            help='Factor by which to downsample labels')
    raw_common.add_argument('--interpolation', default=False, action=AutoBool,
                            help='Interpolate sequence positions between '
                                 'mapped locations')
    raw_common.add_argument('--min_length', default=2500, type=Positive(int),
                            help='Minimum samples in acceptable read')
    raw_common.add_argument('--normalisation', default='per-read',
                            choices=['none', 'per-read', 'per-chunk'])
    raw_common.add_argument('--trim', default=(200, 50), nargs=2,
                            type=NonNegative(int), metavar=('beginning', 'end'),
                            help='Samples to trim from read ends')

    remap_common = argparse.ArgumentParser(add_help=False)
    remap_common.add_argument('--batch', default=64, type=Positive(int),
                              help='Reads remapped per device batch (a batch '
                                   'that exhausts device memory is re-run '
                                   'as two halves)')
    remap_common.add_argument('--min_prob', default=1e-5, type=proportion,
                              help='Posterior probability floor')
    remap_common.add_argument('--prior', nargs=2, metavar=('start', 'end'),
                              default=(25.0, 25.0),
                              type=Maybe(NonNegative(float)),
                              help='Mean of geometric start/end position '
                                   'priors')
    remap_common.add_argument('--slip', default=5.0,
                              type=Maybe(NonNegative(float)),
                              help='Slip penalty')
    remap_common.add_argument('--devices', default=1, type=Positive(int),
                              help='Ranks (one a device) to share the '
                                   'reads over')
    remap_common.add_argument('--dac', default=False, action=AutoBool,
                              help='Ship raw int16 DAC samples and '
                                   'normalise on the device (raw_remap '
                                   'only). Signal values differ from the '
                                   'host loader by <=2 ulp of f32 scaling')
    remap_common.add_argument('--band', default='auto',
                              help='Remap DP band width in sequence '
                                   'positions: "auto" (768 on CUDA, exact '
                                   'on the CPU), "exact", or an integer')
    remap_common.add_argument('--device', default='cuda',
                              help='Torch device to remap on')
    remap_common.add_argument('model',
                              help='Model for remapping (.npz checkpoint, '
                                   '.json or reference .pkl)')
    remap_common.add_argument('references', action=FileExists,
                              help='FASTA of per-read references')

    from sloika_tpu_torch.data import chunkify_tools as tools
    sub = parser.add_subparsers(dest='command', required=True)
    p = sub.add_parser('identity', parents=[common, ev_common],
                       help='Chunk mapped event files',
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.set_defaults(command_action=tools.chunkify_with_identity_main)
    p = sub.add_parser('remap', parents=[common, ev_common, remap_common],
                       help='Remap event reads to references then chunk',
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument('--output_strand_list', default='strand_output_list.txt',
                   help='Strand summary output file')
    p.add_argument('--segmentation', default='Segmentation',
                   help='Segmentation analysis name (accepted; the event '
                        'reader takes the Basecall_1D/2D table)')
    p.set_defaults(command_action=tools.chunkify_with_remap_main)
    p = sub.add_parser('raw_identity', parents=[common, raw_common],
                       help='Chunk raw reads using in-file mappings',
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.set_defaults(command_action=tools.raw_chunkify_with_identity_main)
    p = sub.add_parser('raw_remap', parents=[common, raw_common, remap_common],
                       help='Remap raw reads to references then chunk',
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument('--open_pore_fraction', default=0.3, type=proportion,
                   help='Max fraction of signal to trim as open pore')
    p.add_argument('--output_strand_list', default='strand_output_list.txt',
                   help='Strand summary output file')
    p.set_defaults(command_action=tools.raw_chunkify_with_remap_main)
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    from sloika_tpu_torch.parallel import mesh
    # identity and raw_identity run on the host: their ranks are the
    # launcher's, on the CPU
    code = mesh.launch(main, argv, getattr(args, 'devices', None),
                       getattr(args, 'device', 'cpu'))
    if code is not None:            # the ranks this command started
        return code
    args.command_action(args)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
