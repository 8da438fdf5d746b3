"""The chunkify mains of the port (cf. ``sloika_tpu/data/
chunkify_tools.py``): ``identity`` and ``raw_identity`` chunk reads by the
mapping tables in their files; ``remap`` and ``raw_remap`` remap event or
raw reads against their references in device batches
(:class:`sloika_tpu_torch.remap.Remapper`) first.  Reads are loaded on host
threads; the chunks are written to HDF5 (and, for the remap mains, a
strand summary) in read order: the outputs of the JAX package's
single-process run.

Under a process group (``--devices``, :mod:`sloika_tpu_torch.parallel`)
each rank takes a strided share of the read list on its own device; the
records travel with their index in the read list to rank 0, which writes
the outputs in single-process order (``sloika_tpu/data/chunkify_tools.py:
25-56``).

A read that cannot be loaded, trimmed, remapped or chunked is reported on
stderr and skipped; it never aborts the run.  The remap mains' device parts,
:func:`remap_event_records` and :func:`remap_raw_records`, take reads in
memory (no h5py), so they run where h5py is missing.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sloika_tpu_torch import bio, util
from sloika_tpu_torch.data import batching, features, hdf5, raw_chunkify
from sloika_tpu_torch.data import fast5
from sloika_tpu_torch.data.fast5 import (filename_short, iterate_fast5,
                                         read_raw_signal)
from sloika_tpu_torch.parallel import mesh, multihost


def _finalise(args, records, input_type, strand_header=None,
              strand_path=None):
    """Gather every rank's records to rank 0, which writes the strand list
    and the HDF5 in read-list order (sloika_tpu/data/chunkify_tools.py:
    25-50).

    :param records: [{"index", "chunks", "labels", "bad"[, "strand"]}],
        ``index`` the read's position in the read list
    """
    records = multihost.gather_indexed_arrays([
        (rec["index"], {k: (np.frombuffer(v.encode(), np.uint8)
                            if k == "strand" else v)
                        for k, v in rec.items() if k != "index"})
        for rec in records])
    if mesh.rank() != 0:
        return
    records = [rec for _, rec in records]
    if strand_path is not None:
        with open(strand_path, 'w') as slfh:
            slfh.write(strand_header)
            for rec in records:
                slfh.write(rec["strand"].tobytes().decode())
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


def _map_share(args, load):
    """``load(fn)`` over this rank's strided share of the read list
    (sloika_tpu/data/chunkify_tools.py:53-56, ``_process_share``) on
    ``args.jobs`` threads: (index in the read list, result) of the reads
    that gave one, in read order."""
    share = multihost.process_shard(
        iterate_fast5(args.input_folder, limit=args.limit,
                      strand_list=args.input_strand_list), with_indices=True)
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for (idx, _), res in zip(share,
                                 pool.map(load, [fn for _, fn in share])):
            if res is not None:
                yield idx, res


def _chunk_pool(args, worker):
    """The records of the reads of this rank's share that ``worker(fn)``
    chunked, in read order."""
    records, i = [], 0
    for idx, (chunks, labels, bad_ev) in _map_share(args, worker):
        i = util.progress_report(i)
        records.append({"index": idx, "chunks": np.ascontiguousarray(chunks),
                        "labels": np.ascontiguousarray(labels),
                        "bad": np.ascontiguousarray(bad_ev)})
    return records


def chunkify_with_identity_main(args):
    """Chunk mapped event files (sloika_tpu/data/chunkify_tools.py:94-137)."""
    _guard_overwrite(args, args.output)
    print('* Processing data using', args.jobs, 'threads')

    def worker(fn):
        try:
            ev, _ = fast5.get_any_mapping_data(fn, args.section)
        except Exception as e:        # a malformed file: skip the read
            sys.stderr.write('Failed to get mapping data from {}.\n{}\n'
                             .format(fn, repr(e)))
            return None
        try:
            ev = batching.trim_ends_and_filter(ev, tuple(args.trim),
                                               args.min_length,
                                               args.chunk_len)
            if ev is None:
                sys.stderr.write('{} is too short.\n'.format(fn))
                return None
            return batching.chunkify(ev, args.chunk_len, args.kmer_len,
                                     args.use_scaled, args.normalisation,
                                     alphabet=args.alphabet)
        except Exception as e:        # e.g. kmers outside the alphabet
            sys.stderr.write('Failed to chunk {}.\n{}\n'.format(fn, repr(e)))
            return None

    _finalise(args, _chunk_pool(args, worker), 'events')


def raw_chunkify_with_identity_main(args):
    """Chunk raw signal by the mapping tables in the files
    (sloika_tpu/data/chunkify_tools.py:144-204)."""
    _guard_overwrite(args, args.output)
    print('* Processing data using', args.jobs, 'threads')

    def worker(fn):
        try:
            mapping_table, att = fast5.get_any_mapping_data(fn, 'template')
            sig = read_raw_signal(fn)
            rate = fast5.sample_rate(fn)
            start_sample = fast5.raw_start_sample(fn)
        except Exception as e:        # a malformed file: skip the read
            sys.stderr.write('Failed to get mapping data from {}.\n{}\n'
                             .format(fn, repr(e)))
            return None
        try:
            mapping_table = raw_chunkify.convert_mapping_times_to_samples(
                mapping_table, start_sample, rate)
            map_start = mapping_table['start'][0] + args.trim[0]
            map_end = (mapping_table['start'][-1]
                       + mapping_table['length'][-1] - args.trim[1])
            mapped_signal, mapping_table = \
                raw_chunkify.trim_signal_and_mapping(
                    sig, mapping_table, map_start, map_end)
            if not raw_chunkify.mapping_table_is_registered(mapped_signal,
                                                            mapping_table):
                sys.stderr.write('Failed to register signal and mapping in '
                                 '{}.\n'.format(fn))
                return None
            if len(mapped_signal) < max(args.chunk_len, args.min_length):
                sys.stderr.write('{} is too short.\n'.format(fn))
                return None
            return raw_chunkify.raw_chunkify(
                mapped_signal, mapping_table, args.chunk_len, args.kmer_len,
                args.normalisation, args.downsample_factor,
                args.interpolation, att, alphabet=args.alphabet)
        except Exception as e:        # an empty or foreign mapping table
            sys.stderr.write('Failed to chunk {}.\n{}\n'.format(fn, repr(e)))
            return None

    _finalise(args, _chunk_pool(args, worker), 'raw')


def remap_event_records(remapper, names, events, references, args,
                        indices=None):
    """The device part of ``remap``: remap trimmed event tables against
    their references and chunk them (sloika_tpu/data/chunkify_tools.py:
    383-419).  In memory: no file is read or written.

    :param names: read names;  :param events: their event record arrays
    :param references: their reference sequences (bytes)
    :param args: chunk_len, kmer_len, use_scaled, normalisation, alphabet
    :param indices: the reads' positions in the read list (default: their
        order here)
    :returns: [{"index", "chunks", "labels", "bad", "strand"}] of the reads
        that chunked, in order
    """
    import numpy.lib.recfunctions as nprf
    feats = [features.from_events(ev, tag='') for ev in events]
    print('* Remapping {} reads on {}'.format(len(names), remapper.device))
    results = remapper.remap_signals(feats, references)
    records = []
    i = 0
    indices = range(len(names)) if indices is None else indices
    for idx, sn, ev, ref, res in zip(indices, names, events, references,
                                     results):
        if res is None:
            continue
        score, _mapping, path, seq = res
        kmers = np.array(bio.seq_to_kmers(ref, args.kmer_len))
        try:
            ev2 = nprf.append_fields(
                ev, ['seq_pos', 'kmer', 'good_emission'],
                [path, kmers[path], np.repeat(True, len(ev))])
            chunks, labels, bad_ev = batching.chunkify(
                ev2, args.chunk_len, args.kmer_len, args.use_scaled,
                args.normalisation, alphabet=args.alphabet)
        except Exception as e:        # e.g. kmers outside the alphabet
            sys.stderr.write('Failure chunking {}.\n{}\n'.format(sn, repr(e)))
            continue
        i = util.progress_report(i)
        row = '\t'.join(str(x) for x in [
            sn + '.fast5', len(ev), -score / len(ev),
            int(np.sum(np.ediff1d(path, to_begin=1) == 0)), len(seq),
            int(path.min()), int(path.max())]) + '\n'
        records.append({"index": idx, "chunks": chunks, "labels": labels,
                        "bad": bad_ev, "strand": row})
    return records


def chunkify_with_remap_main(args):
    """Remap event reads against references, then chunk
    (sloika_tpu/data/chunkify_tools.py:330-421)."""
    _guard_overwrite(args, args.output, args.output_strand_list)
    if args.dac:
        sys.stderr.write('--dac applies to raw_remap only (event features '
                         'are not DAC samples); ignored.\n')
    references = util.fasta_file_to_dict(args.references)
    remapper = _load_remap_model(args)

    def load(fn):
        """(name, trimmed events) of one read, or None.  ``--segmentation``
        names an analysis the reader does not consult: both of the JAX
        reader's calls read the Basecall_1D/2D event table
        (sloika_tpu/data/chunkify_tools.py:350-355)."""
        try:
            sn = filename_short(fn)
            ev = fast5.read_section_events(fn, args.section)
        except Exception as e:        # a malformed file: skip the read
            sys.stderr.write('Failure reading events from {}.\n{}\n'
                             .format(fn, repr(e)))
            return None
        if sn not in references:
            sys.stderr.write('No reference found for {}.\n'.format(sn))
            return None
        try:
            ev = batching.trim_ends_and_filter(ev, tuple(args.trim),
                                               args.min_length,
                                               args.chunk_len)
        except Exception as e:
            sys.stderr.write('Failure trimming events from {}.\n{}\n'
                             .format(fn, repr(e)))
            return None
        if ev is None:
            sys.stderr.write('{} is too short.\n'.format(fn))
            return None
        return sn, ev

    loaded = list(_map_share(args, load))
    names = [r[0] for _, r in loaded]
    records = remap_event_records(remapper, names, [r[1] for _, r in loaded],
                                  [references[n] for n in names], args,
                                  indices=[i for i, _ in loaded])
    _finalise(args, records, 'events',
              strand_header='\t'.join(['filename', 'nev', 'score', 'nstay',
                                       'seqlen', 'start', 'end']) + '\n',
              strand_path=args.output_strand_list)


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
                    batch_size=args.batch, band=band,
                    device=mesh.local_device(args.device))


def remap_raw_records(remapper, loaded, references, args, indices=None):
    """The device part of ``raw_remap``: remap raw reads against their
    references and chunk them (sloika_tpu/data/chunkify_tools.py:288-321).
    In memory: no file is read or written.

    :param loaded: per read (name, trimmed pA signal) or, with ``args.dac``,
        (name, signal, (dac, norm4)) as :func:`load_raw_dac` gives
    :param references: their reference sequences (bytes)
    :param args: chunk_len, kmer_len, normalisation, downsample_factor,
        interpolation, alphabet, dac
    :param indices: the reads' positions in the read list (default: their
        order here)
    :returns: [{"index", "chunks", "labels", "bad", "strand"}] of the reads
        that chunked, in order
    """
    print('* Remapping {} reads on {}'.format(len(loaded), remapper.device))
    if args.dac:
        results = remapper.remap_dac_signals([r[2] for r in loaded],
                                             references)
    else:
        results = remapper.remap_signals(
            [batching.normalise_raw_signal(r[1]) for r in loaded], references)

    records = []
    i = 0
    indices = range(len(loaded)) if indices is None else indices
    for idx, (sn, signal, *_), ref, res in zip(indices, loaded, references,
                                               results):
        if res is None:
            continue
        score, mapping_table, path, seq = res
        mapping_attrs = {'reference': ref, 'direction': '+', 'ref_start': 0}
        try:
            chunks, labels, bad_ev = raw_chunkify.raw_chunkify(
                signal.astype(np.float32), mapping_table, args.chunk_len,
                args.kmer_len, args.normalisation, args.downsample_factor,
                args.interpolation, mapping_attrs, alphabet=args.alphabet)
        except Exception as e:        # e.g. kmers outside the alphabet
            sys.stderr.write('Failure chunking {}.\n{}\n'.format(sn, repr(e)))
            continue
        i = util.progress_report(i)
        row = '\t'.join(str(x) for x in [
            sn + '.fast5', len(mapping_table), -score / len(mapping_table),
            int(np.sum(np.ediff1d(path, to_begin=1) == 0)), len(seq),
            int(path.min()), int(path.max())]) + '\n'
        records.append({"index": idx, "chunks": chunks, "labels": labels,
                        "bad": bad_ev, "strand": row})
    return records


def raw_chunkify_with_remap_main(args):
    """Remap raw reads against references, then chunk
    (sloika_tpu/data/chunkify_tools.py:231-327)."""
    from sloika_tpu_torch.basecall import load_raw_dac, scale_dac_f32

    _guard_overwrite(args, args.output, args.output_strand_list)
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

    loaded = list(_map_share(args, load))
    records = remap_raw_records(remapper, [r for _, r in loaded],
                                [references[r[0]] for _, r in loaded], args,
                                indices=[i for i, _ in loaded])
    _finalise(args, records, 'raw',
              strand_header='\t'.join(['filename', 'nblocks', 'score',
                                       'nstay', 'seqlen', 'start',
                                       'end']) + '\n',
              strand_path=args.output_strand_list)
