"""``sloika-torch-align``: the accuracy of basecall FASTA files (cf.
``sloika_tpu/cli/align.py``, the reference's misc/align.py)::

    python -m sloika_tpu_torch.cli.align --reference refs.fa calls.fa

Each call is aligned by the port's banded aligner against its read's
reference record (or a single record used for every read, or, with
``--genome``, every contig); a ``.samacc`` metric table and a ``.summary``
report are written beside each input, and the report to stdout.  It runs on
the host.
"""
import argparse
import os
import sys

from sloika_tpu_torch.cmdargs import AutoBool, FileExists, Maybe, proportion


def make_parser():
    parser = argparse.ArgumentParser(
        description='Align basecalls to references and report accuracy',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--coverage', default=0.6, type=proportion,
                        help='Minimum coverage for alignment to count')
    parser.add_argument('--data_set_name', default=None,
                        help='Name for the summary report')
    parser.add_argument('--figure_format', default=None,
                        type=Maybe(str),
                        help='Write an accuracy histogram per input in this '
                             'format (e.g. png, pdf, svg)')
    parser.add_argument('--fill', default=True, action=AutoBool,
                        help='Fill the histogram bars')
    parser.add_argument('--genome', default=False, action=AutoBool,
                        help='Align each call against every reference '
                             'record and keep the best-scoring contig '
                             '(multi-contig genome mode)')
    parser.add_argument('--reference', action=FileExists, required=True,
                        help='Reference FASTA (per-read records, a single '
                             'record used for all reads, or a multi-contig '
                             'genome with --genome)')
    parser.add_argument('files', nargs='+',
                        help='Basecall FASTA files to evaluate')
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    from sloika_tpu_torch import align as align_mod
    from sloika_tpu_torch import util

    with open(args.reference) as fh:
        references = dict(util.parse_fasta(fh))

    exit_code = 0
    for fn in args.files:
        try:
            prefix, _ = os.path.splitext(fn)
            with open(fn) as fh:
                calls = dict(util.parse_fasta(fh))
            rows = align_mod.evaluate_basecalls(calls, references,
                                                min_coverage=args.coverage,
                                                genome=args.genome)
            align_mod.write_samacc(prefix + '.samacc', rows)
            name = args.data_set_name or fn
            if args.figure_format:
                align_mod.save_acc_plot(
                    prefix + '.' + args.figure_format.lstrip('.'), rows,
                    fill=args.fill, title=name)
            report = align_mod.summary(rows, name)
            sys.stdout.write('\n' + report + '\n')
            with open(prefix + '.summary', 'w') as fh:
                fh.write(report)
        except Exception as e:
            sys.stderr.write('{}: something went wrong: {!r}\n'.format(fn, e))
            exit_code = 1
    return exit_code


if __name__ == '__main__':
    raise SystemExit(main())
