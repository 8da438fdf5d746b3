"""The ``raw_remap`` chunkify main of the port (cf.
``sloika_tpu/data/chunkify_tools.py``): raw reads are loaded and trimmed on
host threads, remapped against their references in device batches
(:class:`sloika_tpu_torch.remap.Remapper`), then cut into labelled chunks
and written to HDF5 with a strand summary.  One process; the outputs are
those of the JAX package's single-process run.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sloika_tpu_torch import util
from sloika_tpu_torch.data import batching, hdf5, raw_chunkify
from sloika_tpu_torch.data.fast5 import (filename_short, iterate_fast5,
                                         read_raw_signal)


def _finalise(args, records, input_type, strand_header=None,
              strand_path=None):
    """Write the strand list and the HDF5 (sloika_tpu/data/
    chunkify_tools.py:25, without the multihost gather).

    :param records: [{"chunks", "labels", "bad", "strand"}] in the read
        list's order
    """
    if strand_path is not None:
        with open(strand_path, 'w') as slfh:
            slfh.write(strand_header)
            for rec in records:
                slfh.write(rec["strand"])
    _write_output(args, [rec["chunks"] for rec in records],
                  [rec["labels"] for rec in records],
                  [rec["bad"] for rec in records], input_type)


def _write_output(args, chunk_list, label_list, bad_list, input_type):
    """(copied from sloika_tpu/data/chunkify_tools.py:59)"""
    if not chunk_list:
        print("no chunks were produced", file=sys.stderr)
        sys.exit(1)
    print('\n* Writing out to HDF5')
    attrs = {
        'chunk': args.chunk_len,
        'input_type': input_type,
        'kmer': args.kmer_len,
        'normalisation': args.normalisation,
        'section': getattr(args, 'section', 'template'),
        'trim': list(args.trim),
        'alphabet': args.alphabet,
    }
    if input_type == 'raw':
        attrs['downsample_factor'] = args.downsample_factor
        attrs['interpolation'] = args.interpolation
    blanks_per_chunk = np.concatenate([(l == 0).mean(1) for l in label_list])
    blanks = np.percentile(blanks_per_chunk, args.blanks_percentile)
    hdf5.create_labelled_chunks_hdf5(args.output, blanks, attrs, chunk_list,
                                     label_list, bad_list)


def _guard_overwrite(args, *paths):
    """(copied from sloika_tpu/data/chunkify_tools.py:82)"""
    if not args.overwrite:
        for p in paths:
            if p and os.path.exists(p):
                print("Cowardly refusing to overwrite {}".format(p))
                sys.exit(1)


def _load_remap_model(args):
    """The Remapper of the CLI's options, from a model ``.npz`` checkpoint,
    JSON or reference ``.pkl`` (sloika_tpu/data/chunkify_tools.py:212)."""
    from sloika_tpu_torch.cli.basecall import load_model
    from sloika_tpu_torch.remap import Remapper
    band = args.band
    if band == 'exact':
        band = None
    elif band != 'auto':
        band = int(band)
    return Remapper(load_model(args.model), args.kmer_len,
                    min_prob=args.min_prob, slip=args.slip,
                    prior=tuple(args.prior), alphabet=args.alphabet,
                    batch_size=args.batch, band=band, device=args.device)


def raw_chunkify_with_remap_main(args):
    """Remap raw reads against references, then chunk
    (sloika_tpu/data/chunkify_tools.py:231-327)."""
    from sloika_tpu_torch.basecall import load_raw_dac, scale_dac_f32

    _guard_overwrite(args, args.output, args.output_strand_list)
    files = iterate_fast5(args.input_folder, limit=args.limit,
                          strand_list=args.input_strand_list)
    references = util.fasta_file_to_dict(args.references)
    remapper = _load_remap_model(args)

    def load(fn):
        """(name, signal for chunking[, (dac, norm4)]) of one read, or None"""
        if args.dac:
            r = load_raw_dac(fn, trim=tuple(args.trim),
                             open_pore_fraction=args.open_pore_fraction)
            if r is None:
                return None
            sn, dac, norm4 = r
            if sn not in references:
                sys.stderr.write('No reference found for {}.\n'.format(sn))
                return None
            if len(dac) < max(args.chunk_len, args.min_length):
                sys.stderr.write('{} is too short.\n'.format(fn))
                return None
            # the chunks are cut from the pA-scaled signal, in the
            # device's float32 order
            return sn, scale_dac_f32(dac, norm4[0], norm4[1]), (dac, norm4)
        try:
            signal = read_raw_signal(fn)
            sn = filename_short(fn)
        except (OSError, KeyError, IndexError) as e:
            sys.stderr.write('Failure reading {}.\n{}\n'.format(fn, repr(e)))
            return None
        if sn not in references:
            sys.stderr.write('No reference found for {}.\n'.format(sn))
            return None
        start, end = batching.trim_open_pore(signal, args.open_pore_fraction)
        signal = util.trim_array(signal[start:end], *args.trim)
        if len(signal) < max(args.chunk_len, args.min_length):
            sys.stderr.write('{} is too short.\n'.format(fn))
            return None
        return sn, signal

    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        loaded = [r for r in pool.map(load, files) if r is not None]
    names = [r[0] for r in loaded]
    refs = [references[n] for n in names]

    print('* Remapping {} reads on {}'.format(len(names), remapper.device))
    if args.dac:
        results = remapper.remap_dac_signals([r[2] for r in loaded], refs)
    else:
        results = remapper.remap_signals(
            [batching.normalise_raw_signal(r[1]) for r in loaded], refs)

    records = []
    i = 0
    for (sn, signal, *_), (score, mapping_table, path, seq) in zip(loaded,
                                                                    results):
        mapping_attrs = {'reference': references[sn], 'direction': '+',
                         'ref_start': 0}
        try:
            chunks, labels, bad_ev = raw_chunkify.raw_chunkify(
                signal.astype(np.float32), mapping_table, args.chunk_len,
                args.kmer_len, args.normalisation, args.downsample_factor,
                args.interpolation, mapping_attrs, alphabet=args.alphabet)
        except (ValueError, IndexError) as e:
            sys.stderr.write('Failure chunking {}.\n{}\n'.format(sn, repr(e)))
            continue
        i = util.progress_report(i)
        row = '\t'.join(str(x) for x in [
            sn + '.fast5', len(mapping_table), -score / len(mapping_table),
            int(np.sum(np.ediff1d(path, to_begin=1) == 0)), len(seq),
            int(path.min()), int(path.max())]) + '\n'
        records.append({"chunks": chunks, "labels": labels, "bad": bad_ev,
                        "strand": row})
    _finalise(args, records, 'raw',
              strand_header='\t'.join(['filename', 'nblocks', 'score',
                                       'nstay', 'seqlen', 'start',
                                       'end']) + '\n',
              strand_path=args.output_strand_list)
