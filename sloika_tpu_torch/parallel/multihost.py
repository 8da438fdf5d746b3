"""Read shares and gathers to rank 0 for the data pipelines (cf.
``sloika_tpu/parallel/multihost.py``).

Every rank takes a strided share of the read list (:func:`process_shard`),
works on its own device, and sends its records to rank 0, which writes one
output in the original read order: byte-identical to a single process where
the device work gives the same bits.  The algorithms and return values are
the JAX package's; the collectives are ``torch.distributed``'s, on the gloo
group for host payloads (:func:`.mesh.host_group`).  Without a group each
function is the single-process identity.
"""
import io
import json

import numpy as np
import torch
import torch.distributed as dist

from sloika_tpu_torch.parallel import mesh


def process_shard(items, with_indices=False):
    """This rank's strided share ``items[rank::world]`` (``multihost.py:
    17-27``): strided rather than blocked, so that the ranks' loads stay
    balanced when read sizes trend over the listing.

    :param with_indices: give ``(index in items, item)`` pairs
    """
    r, n = mesh.rank(), mesh.world_size()
    if with_indices:
        return list(enumerate(items))[r::n]
    return list(items)[r::n]


def _lengths(payload):
    """Every rank's payload length, in rank order."""
    out = [torch.zeros(1, dtype=torch.int64)
           for _ in range(mesh.world_size())]
    dist.all_gather(out, torch.tensor([len(payload)], dtype=torch.int64),
                    group=mesh.host_group())
    return [int(t) for t in out]


def _buffer(payload, size):
    buf = torch.zeros(max(1, size), dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    return buf


def allgather_bytes(payload):
    """Every rank's ``bytes`` payload on every rank, in rank order
    (``multihost.py:30-48``: two collectives, the lengths, then the padded
    data).  Single process: ``[payload]``."""
    if mesh.world_size() == 1:
        return [payload]
    lens = _lengths(payload)
    L = max(1, max(lens))
    bufs = [torch.zeros(L, dtype=torch.uint8) for _ in lens]
    dist.all_gather(bufs, _buffer(payload, L), group=mesh.host_group())
    return [b[:n].numpy().tobytes() for b, n in zip(bufs, lens)]


def gather_bytes_to_rank0(payload):
    """Every rank's ``bytes`` payload on rank 0 only (``multihost.py:
    51-77``).

    One round per source rank (rank r sends, rank 0 receives), so a rank's
    peak memory is its own payload; only rank 0, which writes the merged
    output, holds them all.

    :returns: the payloads in rank order on rank 0; None elsewhere.  Single
        process: ``[payload]``
    """
    if mesh.world_size() == 1:
        return [payload]
    lens = _lengths(payload)
    group, me = mesh.host_group(), mesh.rank()
    if me != 0:
        if lens[me]:
            dist.send(_buffer(payload, lens[me]), dst=0, group=group)
        return None
    out = [payload]
    for r in range(1, len(lens)):
        if lens[r] == 0:
            out.append(b"")
            continue
        buf = torch.empty(lens[r], dtype=torch.uint8)
        dist.recv(buf, src=r, group=group)
        out.append(buf.numpy().tobytes())
    return out


def gather_indexed_arrays(records):
    """Per-item dicts of numpy arrays from every rank, merged on rank 0 and
    sorted by their index in the read list all ranks agree on
    (``multihost.py:80-110``).

    :param records: ``[(index, {name: ndarray})]``
    :returns: on rank 0 the union, sorted by index; ``[]`` elsewhere.
        Single process: a sorted copy
    """
    if mesh.world_size() == 1:
        return sorted(((i, dict(rec)) for i, rec in records),
                      key=lambda r: r[0])
    flat = {}
    for idx, rec in records:
        for k, v in rec.items():
            flat["{}::{}".format(idx, k)] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    payloads = gather_bytes_to_rank0(buf.getvalue())
    if payloads is None:
        return []
    merged = {}
    for payload in payloads:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            for key in z.files:
                idx, name = key.split("::", 1)
                merged.setdefault(int(idx), {})[name] = z[key]
    return sorted(merged.items())


def allgather_records(records):
    """A JSON-serialisable list from every rank, concatenated in rank order
    on every rank (``multihost.py:113-120``)."""
    out = []
    for p in allgather_bytes(json.dumps(records).encode()):
        out.extend(json.loads(p.decode()))
    return out
