"""Basecall reads with the PyTorch port (cf. ``sloika_tpu/cli/basecall.py``).

Two subcommands::

    python -m sloika_tpu_torch.cli.basecall raw model.npz reads/ \\
        --device cuda --output calls.fa
    python -m sloika_tpu_torch.cli.basecall events model.npz reads/ \\
        --device cuda --output calls.fa

The model is a ``.npz`` checkpoint or a model JSON of either package, or
a reference Theano pickle (``.pkl``); ``--transducer``, ``--bad``,
``--alphabet`` and ``--kmer_len`` describe its output states.

Both decode as the JAX package does by default: whole reads in batches of
``--batch``, in order of length (``--no-chunked``), ``raw`` from signals
normalised on the host (``--trim``, ``--open_pore_fraction``), ``events``
from event features (``--section``, ``--trim``).  With ``--chunked`` they
cut the reads into windows.  ``--device_collapse`` ("auto": on for a
chunked 4-letter transducer on a CUDA device, where the JAX package's TPU
stands) collapses the calls to bases on the device; else the windows'
paths are stitched on the host ("states").  ``--dac`` ("auto": on with
device collapse) ships ``raw`` reads as int16 DAC samples, windowed and
normalised on the device.  A non-transducer model (``--transducer false``)
is decoded on the host with the legacy decoder.  A CRF model (bonito's,
ending in ``LinearCRF``) is always chunked and collapsed to bases on the
device, on any device (its CTC-CRF decode, ``ops/crf_decode``);
``--device_collapse off`` is refused for it.  A model with a
``Studentise`` layer runs whole reads one at a time, unpadded
(``Basecaller``).  ``--jobs`` threads load the reads, the next block's
while the current block decodes.  FASTA goes to stdout unless ``--output``
is given, in the order of the input files.  ``--device cuda`` raises when
no GPU is present.

``--devices N`` basecalls over N ranks, one a device
(:mod:`sloika_tpu_torch.parallel`): the command starts them itself, or,
under ``torchrun``, checks N against the launcher's ``WORLD_SIZE``.  Each
rank takes a strided share of the reads, rank 0 gathers the FASTA records
and writes them in the order of the input files, and the report counts
every rank's reads (``sloika_tpu/cli/basecall.py:153-172, 243-262``)::

    python -m sloika_tpu_torch.cli.basecall raw model.npz reads/ \
        --devices 2 --output calls.fa
"""
import argparse
import io
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from sloika_tpu_torch import __version__
from sloika_tpu_torch.cmdargs import (AutoBool, ByteString, FileExists, Maybe,
                                      NonNegative, Positive, proportion,
                                      display_version_and_exit)
from sloika_tpu_torch.data.fast5 import iterate_fast5


def make_parser():
    parser = argparse.ArgumentParser(
        description='Basecall reads with a transducer network (PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument('--alphabet', default=b'ACGT', type=ByteString,
                        help='Alphabet of the model')
    common.add_argument('--bad', default=False, action=AutoBool,
                        help='Model has a bad state')
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
    common.add_argument('--device_collapse', default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Collapse calls to bases on the device (chunked '
                             '4-letter transducer mode; "auto" = on for a '
                             'CUDA device)')
    common.add_argument('--dac', default='auto',
                        choices=['auto', 'on', 'off'],
                        help='Ship raw int16 DAC samples and window + '
                             'normalise on the device (raw reads, device '
                             'collapse; "auto" = on whenever device '
                             'collapse is active)')
    common.add_argument('--devices', default=1, type=Positive(int),
                        help='Ranks (one a device) to share the reads '
                             'over')
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
    common.add_argument('--transducer', default=True, action=AutoBool,
                        help='Model is a transducer')
    common.add_argument('--trans', nargs=3, default=None, type=float,
                        metavar=('stay', 'step', 'skip'),
                        help='Base transition probabilities (non-transducer)')
    common.add_argument('--jobs', default=4, type=Positive(int),
                        help='Host threads for read loading')
    common.add_argument('--output', default=None,
                        help='Output FASTA file (default stdout)')
    common.add_argument('--version', nargs=0,
                        action=display_version_and_exit(__version__),
                        help='Display version')
    common.add_argument('model', action=FileExists,
                        help='Checkpoint (.npz), model JSON or reference '
                             'pickle (.pkl)')
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
    """Load a layer (holding its parameters) from a checkpoint, a model
    JSON or a reference Theano pickle (cf. ``sloika_tpu/cli/basecall.py:
    101-112``)."""
    from sloika_tpu_torch import serialize
    if path.endswith('.npz'):
        return serialize.load_checkpoint(path)[0]
    if path.endswith('.json'):
        layer, params = serialize.load_model_json(path)
        if params is None:
            raise ValueError('model JSON has no parameters')
        return layer
    if path.endswith('.pkl'):
        from sloika_tpu_torch.compat import theano_pickle
        return theano_pickle.load_model(path)[0]
    raise ValueError('model must be a .npz checkpoint, a .json model or a '
                     'reference .pkl')


def main(argv=None):
    args = make_parser().parse_args(argv)
    events = args.command == 'events'
    from sloika_tpu_torch import basecall as bc
    from sloika_tpu_torch.parallel import mesh, multihost

    code = mesh.launch(main, argv, args.devices, args.device)
    if code is not None:            # the ranks this command started
        return code
    dev = mesh.local_device(args.device)
    layer = load_model(args.model)
    if bc.crf_head(layer) is not None and args.device_collapse == 'off':
        raise ValueError('a CRF model collapses its calls to bases on the '
                         'device: --device_collapse off does not apply')
    if args.device_collapse == 'auto':
        # the card stands where the JAX package's TPU stands
        device_collapse = (dev.type == 'cuda' and args.chunked
                           and args.transducer and len(args.alphabet) == 4)
    else:
        device_collapse = args.device_collapse == 'on'
    # a CRF model basecalls chunked to bases whatever is asked (Basecaller)
    caller = bc.Basecaller(layer, args.kmer_len,
                           transducer=args.transducer, bad=args.bad,
                           min_prob=args.min_prob, skip=args.skip,
                           trans=args.trans, alphabet=args.alphabet,
                           batch_size=args.batch, chunked=args.chunked,
                           chunk_size=args.chunk_size, overlap=args.overlap,
                           output='bases' if device_collapse else 'states',
                           device=str(dev))
    # a Studentise model falls back to whole reads, "states"
    output = caller.output
    if args.dac == 'auto':
        dac = not events and output == 'bases'
    else:
        dac = args.dac == 'on'
        if dac and (events or output != 'bases'):
            # as sloika_tpu/cli/basecall.py:175-180 asserts
            raise ValueError('--dac on requires raw reads and device '
                             'collapse')
    datatype = 'events' if events else 'samples'
    # several ranks: each writes its records into a buffer, rank 0 the file
    multi = mesh.world_size() > 1
    capture = io.StringIO() if multi else None
    printer = bc.SeqPrinter(datatype=datatype,
                            fname=None if multi else args.output,
                            kmer_len=args.kmer_len,
                            transducer=args.transducer,
                            alphabet=args.alphabet, fh=capture)
    write = printer.write_codes if output == 'bases' else printer.write
    files = iterate_fast5(args.input_folder, strand_list=args.strand_list,
                          limit=args.limit)
    indices = list(range(len(files)))
    if multi:
        share = multihost.process_shard(files, with_indices=True)
        indices, files = [i for i, _ in share], [f for _, f in share]
    if events:
        load = lambda fn: bc.load_event_features(
            fn, section=args.section, segmentation=args.segmentation,
            trim=tuple(args.trim))
    elif dac:
        load = lambda fn: bc.load_raw_dac(
            fn, trim=tuple(args.trim),
            open_pore_fraction=args.open_pore_fraction)
    else:
        load = lambda fn: bc.load_raw_signal(
            fn, trim=tuple(args.trim),
            open_pore_fraction=args.open_pore_fraction)

    t0 = time.time()
    nbases = nsignal = nreads = 0
    records = []                # several ranks: (read index, FASTA text)
    # bounded blocks keep host memory O(block); the next block's loads are
    # submitted before the current block decodes, so loading overlaps the
    # device's work (sloika_tpu/cli/basecall.py:203-212)
    block = max(8 * args.batch, 512)
    try:
        with ThreadPoolExecutor(max_workers=args.jobs) as pool:
            pending = [pool.submit(load, fn) for fn in files[:block]]
            for lo in range(0, len(files), block):
                current, pending = pending, [
                    pool.submit(load, fn)
                    for fn in files[lo + block:lo + 2 * block]]
                loaded = [(i, r) for i, r in zip(indices[lo:lo + block],
                                                 (f.result() for f in current))
                          if r is not None]
                if not loaded:
                    continue
                if dac:
                    results = caller.basecall_dac_reads(
                        [(r[1], r[2]) for _, r in loaded])
                else:
                    results = caller.basecall_signals(
                        [r[1] for _, r in loaded])
                for (i, r), res in zip(loaded, results):
                    if res is None:
                        continue
                    score, call = res
                    nbases += write(r[0], score, call, len(r[1]))
                    nsignal += len(r[1])
                    nreads += 1
                    if multi:
                        records.append((i, capture.getvalue()))
                        capture.seek(0)
                        capture.truncate(0)
    finally:
        printer.close()
    dt = time.time() - t0
    if multi:
        # the counters to every rank, the records to rank 0, which writes
        # them in the order of the input files
        counts = multihost.allgather_records([[nreads, nbases, nsignal]])
        nreads, nbases, nsignal = (sum(c[k] for c in counts)
                                   for k in range(3))
        payloads = multihost.gather_bytes_to_rank0(
            json.dumps(records).encode())
        if payloads is not None:
            merged = sorted((r for p in payloads
                             for r in json.loads(p.decode())),
                            key=lambda r: r[0])
            fh = open(args.output, 'w') if args.output else sys.stdout
            try:
                fh.writelines(text for _, text in merged)
            finally:
                if args.output:
                    fh.close()
    sys.stderr.write(
        'Called {} reads in {:.2f}s ({:.1f} bases/s, {:.1f} {}/s)\n'
        .format(nreads, dt, nbases / dt, nsignal / dt, datatype))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
