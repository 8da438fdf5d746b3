"""Bytes the basecaller copied from the card in the traced window (the
program's ``d2h_bytes`` counter) over the read samples it called there.
None where the program counts no copies."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.bytes_per_sample(ctx, "d2h_bytes")
