"""Bytes the basecaller copied to the card in the traced window (the
program's ``h2d_bytes`` counter) over the read samples it called there.
None where the program counts no copies."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.bytes_per_sample(ctx, "h2d_bytes")
