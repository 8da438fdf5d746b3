"""Inputs made from a run's seed: the network's weights, raw DAC reads and
labelled training chunks.

The reads are ``chip_smoke.py:1175-1191``'s (a step signal, one level a
base held a geometric number of samples, mean 9, scaled to DAC units with
noise), made on the card in bulk.  The chunks are
``sloika_tpu_torch/profile_train.py:39-52``'s (a noisy step signal, one
level a frame, random labels).  Every seed gets the same set of read
lengths, drawn from the traffic's own ``lengths_seed``, in its own order.
"""
import numpy as np
import torch

from benchmark.harness.spec import sub_seed
from benchmark.reference.layers import kind
from benchmark.reference.model import param_shapes


def weights(layers, scheme, seed, device):
    """{name: tensor} of the configuration's parameters: one normal draw
    of a torch generator on ``device``, clipped at +/- 2, scaled by each
    weight's fan as sloika's initialiser scales it and by the traffic's
    ``scheme``: ``sd`` for the weights, ``bias_sd`` for the biases, and the
    rest as the last layer's kind takes it (its ``head_weights``, where it
    has one)."""
    shapes = param_shapes(layers)
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = flat.clamp_(-2.0, 2.0)
    out, lo = {}, 0
    for (name, shape, scale), n in zip(shapes, sizes):
        sd = scheme["bias_sd"] if name.endswith(".b") else scheme["sd"]
        out[name] = (flat[lo:lo + n] * (sd / scale)).reshape(
            shape).contiguous()
        lo += n
    last = len(layers) - 1
    head = getattr(kind(layers[last]["type"]), "head_weights", None)
    if head is not None:
        head(layers[last], last, out, scheme)
    return out


def read_lengths(traffic, seed):
    """The traffic's read lengths in this seed's order."""
    rs = np.random.RandomState(traffic["lengths_seed"])
    lengths = rs.randint(traffic["min_samples"], traffic["max_samples"] + 1,
                         size=traffic["reads"])
    return lengths[np.random.RandomState(sub_seed(seed, 2))
                   .permutation(len(lengths))]


def dac_reads(traffic, seed, device):
    """[(dac (L,) int16, (offset, scale, med, mad) float32)] a read."""
    lengths = read_lengths(traffic, seed)
    total = int(lengths.sum())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    p = 1.0 / traffic["samples_per_base"]
    nlev = int(total * p * 1.25) + 64
    while True:
        u = torch.rand(nlev, generator=gen, device=device,
                       dtype=torch.float64)
        held = torch.floor(torch.log1p(-u) / np.log1p(-p)) + 1
        ends = torch.cumsum(held, 0)
        if float(ends[-1]) >= total:
            break
        nlev *= 2
    levels = torch.randn(nlev, generator=gen, device=device)
    pos = torch.arange(total, device=device, dtype=torch.float64)
    sig = levels[torch.searchsorted(ends, pos, right=True)]
    noise = torch.randn(total, generator=gen, device=device)
    dac = torch.round(sig * 300 + 2000 + noise * 30).to(torch.int16)
    off, sc = np.float32(10.0), np.float32(0.15)
    scaled = (dac.to(torch.float32) + float(off)) * float(sc)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    norms = []
    for a, b in zip(starts[:-1], starts[1:]):
        s = scaled[a:b]
        med = torch.median(s)
        norms.append(torch.stack([med, 1.4826 * torch.median(
            torch.abs(s - med))]))
    norms = torch.stack(norms).cpu().numpy().astype(np.float32)
    host = dac.cpu().numpy()
    return [(host[a:b], (off, sc, m[0], m[1]))
            for a, b, m in zip(starts[:-1], starts[1:], norms)]


def normalise(dac, norm):
    """``((dac + offset) * scale - med) / mad`` in float32, the order the
    program's DAC path uses."""
    off, sc, med, mad = (np.float32(v) for v in norm)
    return ((dac.astype(np.float32) + off) * sc - med) / mad


def chunks(traffic, seed):
    """A labelled-chunk set as ``load_labelled_chunks`` returns it."""
    rs = np.random.RandomState(sub_seed(seed, 4))
    n, samples = traffic["chunks"], traffic["chunk_samples"]
    stride, klen = traffic["stride"], traffic["kmer_len"]
    frames = samples // stride
    levels = rs.normal(size=(n, frames))
    x = np.repeat(levels, stride, axis=1)
    x += rs.normal(scale=0.3, size=x.shape)
    labels = rs.randint(0, 4 ** klen + 1, size=(n, frames)).astype(np.int32)
    return {"chunks": x[:, :, None].astype(np.float32), "labels": labels,
            "bad": np.zeros(labels.shape, bool),
            "weights": np.full(n, 1.0 / n), "attrs": {"kmer": klen}}
