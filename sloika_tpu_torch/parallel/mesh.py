"""The port's process group: one rank a device (cf.
``sloika_tpu/parallel/mesh.py``).

The JAX package runs one process over a 1-D ``('data',)`` mesh, and across
hosts starts ``jax.distributed`` under a coordinator; XLA partitions the
batch and inserts the gradient reduction.  Here each device is a rank of a
``torch.distributed`` group:

* a rank uses ``cuda:(LOCAL_RANK % device_count)``, or the CPU;
* the backend is ``nccl`` when each rank has a card of its own, ``gloo`` on
  the CPU or when ranks share a card (they are allowed, and counted in
  :func:`ranks_per_card`; the tensors stay on the card, only the collective
  goes through the host).  Host payloads (bytes, records) travel on a gloo
  group in either case (:func:`host_group`);
* parameters are replicated: :func:`broadcast_params` from rank 0, and
  after each backward one all-reduce of a flat buffer of every gradient
  (:func:`all_reduce_grads`), summed and divided by the world size, which
  is what the JAX package's partitioned reduction computes;
* every rank samples the same global batch from the shared seed and keeps
  its contiguous block of it (:func:`local_batch_slice`, :func:`local_batch`).

The group starts from a launcher's environment (``torchrun``: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) or from the ranks that
:func:`launch` spawns itself, which meet at a file store.  Every group has a
timeout, so a rank that dies fails the others' collectives instead of
hanging them.  Without a group every function is the single-process
identity.
"""
import atexit
import datetime
import os
import sys

import torch
import torch.distributed as dist

from sloika_tpu_torch import config

#: seconds a collective waits for the other ranks before it raises (gloo's
#: default; the longest wait is rank 0's at a pipeline's final gather, for
#: the slowest share)
TIMEOUT_S = 1800

#: where :mod:`.spawn` tells its ranks the file store they meet at
STORE_ENV = "SLOIKA_TPU_TORCH_STORE"

_state = {"host": None, "ranks_per_card": 1}


def launched():
    """True under a launcher's environment (``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def active():
    """True once this process is a rank of a group."""
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if active() else 0


def world_size():
    return dist.get_world_size() if active() else 1


def backend():
    """The group's backend ("nccl" or "gloo"); None without a group."""
    return dist.get_backend() if active() else None


def ranks_per_card():
    """How many ranks of this host share each card (1 on the CPU)."""
    return _state["ranks_per_card"]


def local_rank():
    return int(os.environ.get("LOCAL_RANK", 0)) if active() else 0


def local_device(device):
    """This rank's device for ``device``: a CUDA device without an index
    becomes ``cuda:(LOCAL_RANK % device_count)`` under a group."""
    dev = config.resolve_device(device)
    if dev.type == "cuda" and dev.index is None and active():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def default_count(device):
    """The JAX default device count: every visible card, one CPU."""
    dev = config.resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def maybe_init_distributed(device="cpu", ndevice=None):
    """Join the group a launcher's environment describes (no-op without
    one, or when this process has joined already); rank 0 writes the
    ranks, backend, devices and card sharing to stderr.

    :param device: the run's device: "cpu" gives gloo; "cuda" gives nccl,
        or gloo when this host starts more ranks (``LOCAL_WORLD_SIZE``)
        than it has cards
    :param ndevice: the run's device count; raises ValueError unless it is
        None or the launcher's ``WORLD_SIZE``
    """
    if active() or not launched():
        return
    n, r = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if ndevice is not None and ndevice != n:
        raise ValueError("the run asks for {} devices but the launcher "
                         "started WORLD_SIZE={} ranks".format(ndevice, n))
    dev = config.resolve_device(device)
    name = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local_n = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        _state["ranks_per_card"] = -(-local_n // cards)
        if local_n <= cards:
            name = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % cards)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = os.environ.get(STORE_ENV)
    dist.init_process_group(
        name, init_method="file://" + store if store else "env://",
        rank=r, world_size=n, timeout=timeout)
    _state["host"] = (dist.new_group(backend="gloo", timeout=timeout)
                      if name == "nccl" else None)
    atexit.register(shutdown)
    line = describe(local_device(dev))
    if r == 0:
        sys.stderr.write("* {}\n".format(line))


def shutdown():
    """Leave the group (no-op without one)."""
    if active():
        dist.destroy_process_group()
    _state["host"] = None
    _state["ranks_per_card"] = 1


def host_group():
    """The gloo group host payloads travel on (None: the default group,
    itself gloo)."""
    return _state["host"]


def launch(entry, argv, ndevice, device="cpu"):
    """Run ``entry(argv)`` on ``ndevice`` ranks, the CLIs' ``--devices`` and
    ``--ndevice``.

    Under a launcher this process joins its group (``ndevice`` checked
    against ``WORLD_SIZE``).  Without one and with ``ndevice`` > 1 it
    starts the ranks itself (:func:`.spawn.run`: each reruns ``entry`` with
    the same arguments) and waits for them.

    :param ndevice: None for :func:`default_count`
    :returns: None where this process is to do the work (a rank, or the
        single process); else the exit code of the ranks it started
    """
    if launched():
        maybe_init_distributed(device, ndevice)
        return None
    n = default_count(device) if ndevice is None else ndevice
    if n <= 1:
        return None
    from sloika_tpu_torch.parallel import spawn
    return spawn.run(entry, argv, n)


def round_up(n, k):
    """Round ``n`` up to a multiple of ``k``."""
    return ((n + k - 1) // k) * k


def local_batch_slice(global_batch):
    """This rank's block of a global batch: ``r*B//n : (r+1)*B//n``
    (``sloika_tpu/parallel/mesh.py:56-63``)."""
    r, n = rank(), world_size()
    return slice(r * global_batch // n, (r + 1) * global_batch // n)


def local_batch(arr, batch_axis=1):
    """This rank's block of a global host batch along ``batch_axis``: the
    counterpart of ``put_host_batch`` (``mesh.py:66-82``).  The identity
    without a group."""
    if world_size() == 1:
        return arr
    sl = [slice(None)] * arr.ndim
    sl[batch_axis] = local_batch_slice(arr.shape[batch_axis])
    return arr[tuple(sl)]


def all_reduce_grads(params, stats=None):
    """Average the parameters' gradients over the ranks, in place, with one
    all-reduce of a flat buffer, and sum ``stats`` (a 1-D float tensor on
    the gradients' device) in the same call.

    :returns: the summed ``stats``; ``stats`` unchanged without a group
    """
    if not active():
        return stats
    grads = [p.grad for p in params]
    parts = [g.reshape(-1) for g in grads]
    if stats is not None:
        parts.append(stats)
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    n, off = world_size(), 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g)).div_(n)
        off += g.numel()
    return flat[off:] if stats is not None else None


def broadcast_params(layer):
    """Give every rank rank 0's parameters (one broadcast of a flat
    buffer)."""
    if not active():
        return
    params = list(layer.parameters())
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, src=0)
        off = 0
        for p in params:
            p.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()


def agree(value):
    """Rank 0's ``value`` (any picklable object) on every rank."""
    if not active():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def device_map(dev):
    """Every rank's device, as strings in rank order."""
    if not active():
        return [str(dev)]
    out = [None] * world_size()
    dist.all_gather_object(out, str(dev), group=host_group())
    return out


def describe(dev):
    """One line for the logs: ranks, backend, devices, card sharing (the
    device alone without a group)."""
    if not active():
        return str(dev)
    devs = device_map(dev)
    line = "{} ranks, backend {}, devices {}".format(
        world_size(), backend(), ", ".join(
            "rank {} {}".format(r, d) for r, d in enumerate(devs)))
    if ranks_per_card() > 1:
        line += "; {} ranks share each card".format(ranks_per_card())
    return line
