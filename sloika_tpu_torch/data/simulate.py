"""Synthetic nanopore reads with known references (cf.
``sloika_tpu/data/simulate.py``).

Each 5-mer has a characteristic current level (:func:`pore_model`); a base
dwells for a random number of samples; white Gaussian noise is added to
each sample.  A read is a random substring of one genome
(:func:`random_genome`), so its reference is known and the whole pipeline,
basecall -> extract_reference -> align, can score its calls.
:func:`write_fast5` writes a read in the single-read fast5 schema the
readers of :mod:`sloika_tpu_torch.data.fast5` take (h5py is imported there
only, so the rest runs without it):

    Raw/Reads/Read_0/Signal + start_time                   int16 raw signal
    UniqueGlobalKey/channel_id                             scaling attrs
    Analyses/AlignToRef_000/CurrentSpaceMapped_template/Events   mapping
    Analyses/AlignToRef_000/Summary/current_space_map_template   direction
    Analyses/Alignment_000/Aligned_template/Fasta          per-read reference
"""
import os

import numpy as np

from sloika_tpu_torch import bio

ALPHABET = b'ACGT'
SAMPLE_RATE = 4000.0


def pore_model(kmer_len=5, seed=101, idio=0.10):
    """Characteristic level per kmer: structured + idiosyncratic
    (sloika_tpu/data/simulate.py:39).

    Real pore responses are dominated by additive per-position base
    contributions (centre positions strongest), with smaller kmer-specific
    deviations.  A purely iid level table is an arbitrary 1024-way hash —
    nearly unlearnable at realistic noise (the typical nearest-level gap,
    ~4/nkmer, sits far below per-sample noise) — while a purely additive
    one is trivially linear; this mixes the two:

        level(kmer) = sum_j w_j * v[j, base_j] + idio * eps_kmer

    with fixed weights w = (0.3, 0.25, 0.2, 0.15, 0.1) and v, eps standard
    normals (fixed seed), normalised to unit level std so ``noise_sd`` in
    :func:`simulate_read` means the same signal-to-noise ratio regardless
    of the table's structure.
    """
    rs = np.random.RandomState(seed)
    nbase = len(ALPHABET)
    weights = np.linspace(0.3, 0.1, kmer_len)
    v = rs.normal(size=(kmer_len, nbase)).astype(np.float32)
    eps = rs.normal(size=nbase ** kmer_len).astype(np.float32)
    codes = np.arange(nbase ** kmer_len)
    level = np.zeros(nbase ** kmer_len, dtype=np.float32)
    for j in range(kmer_len):
        digit = (codes // nbase ** (kmer_len - 1 - j)) % nbase
        level += np.float32(weights[j]) * v[j, digit]
    level = level + np.float32(idio) * eps
    return ((level - level.mean()) / level.std()).astype(np.float32)


def random_genome(length, seed=0):
    """A uniform random sequence over ACGT (sloika_tpu/data/simulate.py:70)."""
    rs = np.random.RandomState(seed)
    return bytes(rs.choice(np.frombuffer(ALPHABET, np.uint8), size=length))


def _kmer_codes(seq, kmer_len):
    return bio.kmer_state_array(seq, kmer_len, alphabet=ALPHABET)


def simulate_read(genome, rs, read_len=6000, kmer_len=5, levels=None,
                  noise_sd=0.25, dwell_min=5, dwell_mean=9.0):
    """One synthetic read: a random genome substring rendered to signal
    (sloika_tpu/data/simulate.py:80).

    :param genome: bytes genome to sample from
    :param rs: ``np.random.RandomState``
    :param read_len: read length in bases
    :param levels: per-kmer level table (``pore_model()`` by default)
    :param noise_sd: per-sample white noise, in level-table units
    :param dwell_min: minimum dwell (samples per kmer position); keep >=
        the training label stride so every base is representable
    :param dwell_mean: mean dwell in samples
    :returns: dict with ``signal`` (float32), ``sequence`` (bytes),
        ``dwells`` (int per kmer position), ``levels_used``
    """
    if levels is None:
        levels = pore_model(kmer_len)
    start = rs.randint(0, len(genome) - read_len + 1)
    seq = genome[start:start + read_len]
    codes = _kmer_codes(seq, kmer_len)              # (read_len - k + 1,)
    # dwell = min + geometric tail (mean - min), per kmer position
    p = 1.0 / max(dwell_mean - dwell_min + 1.0, 1.0)
    dwells = dwell_min + rs.geometric(p, size=len(codes)) - 1
    step_levels = levels[codes]
    signal = np.repeat(step_levels, dwells)
    signal = signal + rs.normal(scale=noise_sd, size=len(signal))
    return {"signal": signal.astype(np.float32), "sequence": seq,
            "dwells": dwells, "codes": codes}


def quantise(signal):
    """int16 DAC counts of a simulated signal, as :func:`write_fast5`
    stores them: 1 level unit = 300 counts about 2,000 (quantisation noise
    ~0.003 levels, far under noise_sd).  The file's channel scaling (range
    == digitisation, offset 0) reads the counts back as pA unchanged."""
    return np.clip(np.round(signal * 300.0 + 2000.0), -32768, 32767) \
        .astype(np.int16)


def write_fast5(path, read, read_number=0):
    """Write one simulated read in the single-read fast5 schema (see the
    module docstring; sloika_tpu/data/simulate.py:110)."""
    import h5py
    sig = read["signal"]
    seq = read["sequence"]
    dwells = read["dwells"]
    kmer_len = len(seq) - len(read["codes"]) + 1

    quant = quantise(sig)

    starts = np.concatenate([[0], np.cumsum(dwells)[:-1]])
    n = len(dwells)
    table = np.empty(n, dtype=[('start', '<f8'), ('length', '<f8'),
                               ('mean', '<f8'), ('stdv', '<f8'),
                               ('seq_pos', '<i4'), ('kmer', 'S%d' % kmer_len),
                               ('good_emission', '?')])
    table['start'] = starts / SAMPLE_RATE
    table['length'] = dwells / SAMPLE_RATE
    table['mean'] = np.add.reduceat(sig, starts) / dwells
    table['stdv'] = 0.0
    table['seq_pos'] = np.arange(n)
    table['kmer'] = [seq[i:i + kmer_len] for i in range(n)]
    table['good_emission'] = True

    name = os.path.splitext(os.path.basename(path))[0]
    with h5py.File(path, "w") as h5:
        raw = h5.create_group("Raw/Reads/Read_%d" % read_number)
        raw.create_dataset("Signal", data=quant)
        raw.attrs["start_time"] = np.uint64(0)
        raw.attrs["duration"] = np.uint32(len(quant))
        raw.attrs["read_id"] = np.bytes_(name.encode())
        raw.attrs["read_number"] = np.uint32(read_number)
        ch = h5.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["channel_number"] = "1"
        ch.attrs["digitisation"] = np.float64(8192.0)
        ch.attrs["range"] = np.float64(8192.0)     # pA == counts
        ch.attrs["offset"] = np.float64(0.0)
        ch.attrs["sampling_rate"] = np.float64(SAMPLE_RATE)
        ev = h5.create_group("Analyses/AlignToRef_000/"
                             "CurrentSpaceMapped_template")
        ev.create_dataset("Events", data=table)
        summ = h5.create_group("Analyses/AlignToRef_000/Summary/"
                               "current_space_map_template")
        summ.attrs["direction"] = "+"
        summ.attrs["genome"] = "synthetic"
        summ.attrs["genome_start"] = np.int64(0)
        summ.attrs["genome_end"] = np.int64(len(seq))
        summ.attrs["num_skips"] = np.int64(0)
        summ.attrs["num_stays"] = np.int64(0)
        fasta = ">%s\n%s\n" % (name, seq.decode())
        h5.create_group("Analyses/Alignment_000/Aligned_template") \
            .create_dataset("Fasta", data=fasta)


def simulate_read_set(outdir, n_reads, genome_len=300000, read_len=6000,
                      kmer_len=5, noise_sd=0.3, dwell_min=5, dwell_mean=9.0,
                      genome_seed=0, read_seed=1, prefix="synth"):
    """Write ``n_reads`` simulated fast5 reads; returns (genome, filenames)
    (sloika_tpu/data/simulate.py:167).

    Reads are iid random substrings of one genome, so train/holdout splits
    of the read set share the genome (like resequencing runs) but never the
    exact signal.
    """
    os.makedirs(outdir, exist_ok=True)
    genome = random_genome(genome_len, seed=genome_seed)
    levels = pore_model(kmer_len)
    rs = np.random.RandomState(read_seed)
    files = []
    for i in range(n_reads):
        read = simulate_read(genome, rs, read_len=read_len,
                             kmer_len=kmer_len, levels=levels,
                             noise_sd=noise_sd, dwell_min=dwell_min,
                             dwell_mean=dwell_mean)
        fn = os.path.join(outdir, "%s_%04d.fast5" % (prefix, i))
        write_fast5(fn, read, read_number=i)
        files.append(fn)
    return genome, files
