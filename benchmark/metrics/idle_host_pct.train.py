"""The share of the traced window in which nothing ran on the card while
the host was in the training loop's own work between replays: the
innermost main-thread program span ``train.wait_group``,
``train.capture``, ``train.scalars``, ``train.log_sync`` or
``train.checkpoint`` (``benchmark/harness/program_spans.py`` puts the
program's spans on the trace's clock).  None where the program records no
spans."""
from benchmark.harness import program_spans

HOST = ("train.wait_group", "train.capture", "train.scalars",
        "train.log_sync", "train.checkpoint")


def read(ctx):
    return program_spans.idle_host_pct(ctx, HOST)
