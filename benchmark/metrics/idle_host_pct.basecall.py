"""The share of the traced window in which nothing ran on the card while
the host was in the basecaller's own work between launches: the innermost
main-thread program span ``basecall.pack``, ``basecall.h2d``,
``basecall.unpack``, ``basecall.stitch`` or ``basecall.collapse``
(``benchmark/harness/program_spans.py`` puts the program's spans on the
trace's clock).  None where the program records no spans."""
from benchmark.harness import program_spans

HOST = ("basecall.pack", "basecall.h2d", "basecall.unpack",
        "basecall.stitch", "basecall.collapse")


def read(ctx):
    return program_spans.idle_host_pct(ctx, HOST)
