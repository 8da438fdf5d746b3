"""``sloika-torch-get-refs-from-sam``: padded per-read reference
sub-sequences from a SAM alignment, for remap training (cf.
``sloika_tpu/cli/get_refs_from_sam.py``, the reference's
misc/get_refs_from_sam.py)::

    python -m sloika_tpu_torch.cli.get_refs_from_sam genome.fa reads.sam \\
        --output_strand_list strands.txt > refs.fa
"""
import argparse
import os
import sys

from sloika_tpu_torch.cmdargs import FileExists, NonNegative, proportion
from sloika_tpu_torch import bio, util

STRAND = {0: '+', 16: '-'}


def make_parser():
    parser = argparse.ArgumentParser(
        description='Extract per-read references from a SAM alignment',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--coverage', default=0.6, type=proportion,
                        help='Minimum alignment coverage of the read')
    parser.add_argument('--pad', default=50, type=NonNegative(int),
                        help='Padding either side of the mapped region')
    parser.add_argument('--output_strand_list', default=None,
                        help='Write a strand list of extracted reads')
    parser.add_argument('reference', action=FileExists,
                        help='Genome reference FASTA')
    parser.add_argument('input', action=FileExists, help='SAM file')
    return parser


def trim_fast5_extension(fn):
    basename, ext = os.path.splitext(fn)
    return basename if ext == '.fast5' else fn


def get_refs(sam_path, ref_seq_dict, min_coverage=0.6, pad=50):
    """Yield (read_name.fast5, fasta_record) per acceptably-mapped read
    (reference get_refs_from_sam.py:40-68;
    sloika_tpu/cli/get_refs_from_sam.py:36)."""
    from sloika_tpu_torch.data.sam import read_sam
    for read in read_sam(sam_path):
        if read.flag not in (0, 16):
            continue
        coverage = float(read.query_alignment_length) / max(read.query_length, 1)
        if coverage < min_coverage:
            continue
        ref = ref_seq_dict.get(read.rname)
        if ref is None:
            continue
        if isinstance(ref, bytes):
            ref = ref.decode('ascii')

        start = max(0, read.reference_start - read.query_alignment_start - pad)
        end = min(len(ref), read.reference_end + read.query_length
                  - read.query_alignment_end + pad)
        read_ref = ref[start:end].upper()
        if STRAND[read.flag] == '-':
            read_ref = bio.reverse_complement(read_ref)
        fasta = '>{}\n{}\n'.format(trim_fast5_extension(read.qname), read_ref)
        yield read.qname + '.fast5', fasta


def main(argv=None):
    args = make_parser().parse_args(argv)
    sys.stderr.write('* Loading references\n')
    with open(args.reference) as fh:
        references = dict(util.parse_fasta(fh))

    sys.stderr.write('* Extracting read references using SAM alignment\n')
    strand_list = []
    for name, fasta in get_refs(args.input, references, args.coverage,
                                args.pad):
        strand_list.append(name)
        sys.stdout.write(fasta)

    if args.output_strand_list is not None:
        with open(args.output_strand_list, 'w') as fh:
            fh.write('filename\n')
            fh.write('\n'.join(strand_list) + '\n')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
