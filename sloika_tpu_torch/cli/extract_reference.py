"""``sloika-torch-extract-reference``: each read's reference sequence out of
its fast5 file, as FASTA (cf. ``sloika_tpu/cli/extract_reference.py``, the
reference's bin/extract_reference.py)::

    python -m sloika_tpu_torch.cli.extract_reference reads/ --output refs.fa

``--jobs`` threads read the files; records are written in the order of the
files.  h5py is imported by the reader.
"""
import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

from sloika_tpu_torch.cmdargs import (FileExists, Maybe, Positive,
                                display_version_and_exit)
from sloika_tpu_torch import __version__


def make_parser():
    parser = argparse.ArgumentParser(
        description='Extract per-read reference sequences from fast5 files',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--jobs', default=8, type=Positive(int),
                        help='Host threads')
    parser.add_argument('--limit', default=None, type=Maybe(Positive(int)),
                        help='Limit number of reads')
    parser.add_argument('--section', default='template',
                        choices=['template', 'complement'])
    parser.add_argument('--strand_list', default=None, action=FileExists,
                        help='Strand list restricting reads')
    parser.add_argument('--output', default=None,
                        help='Output FASTA (default stdout)')
    parser.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    parser.add_argument('input_folder', action=FileExists,
                        help='Directory containing fast5 files')
    return parser


def reference_extraction_worker(file_name, section):
    """(read name, reference bytes) of one file, or None where it has none
    (sloika_tpu/cli/extract_reference.py:35)."""
    from sloika_tpu_torch.data import fast5
    try:
        return (fast5.filename_short(file_name),
                fast5.read_reference_fasta(file_name, section=section))
    except Exception as e:        # one bad file does not stop the rest
        sys.stderr.write('Failure reading reference from {}.\n{}\n'.format(
            file_name, repr(e)))
        return None


def main(argv=None):
    args = make_parser().parse_args(argv)
    from sloika_tpu_torch.data.fast5 import iterate_fast5

    files = iterate_fast5(args.input_folder, limit=args.limit,
                          strand_list=args.strand_list)
    out = open(args.output, 'w') if args.output else sys.stdout
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for res in pool.map(
                lambda fn: reference_extraction_worker(fn, args.section),
                files):
            if res is not None:
                name, seq = res
                if isinstance(seq, bytes):
                    seq = seq.decode('ascii')
                out.write('>{}\n{}\n'.format(name, seq))
    if args.output:
        out.close()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
