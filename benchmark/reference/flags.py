"""The options of a job as its command line states them, read without the
program's parser: ``-k 2`` style options with a value, and switches."""

from __future__ import annotations

SWITCHES = {"--EM", "--CGS", "--FDR", "--scoreSeqset", "--optimizeQ", "--jsonl", "--ss"}


def parse(argv: list) -> dict:
    """{option: value string} and {switch: True} of ``argv`` past its two
    positional arguments."""
    out, i = {}, 0
    while i < len(argv):
        a = argv[i]
        if a in SWITCHES:
            out[a] = True
            i += 1
        elif a.startswith("-"):
            out[a] = argv[i + 1]
            i += 2
        else:
            i += 1
    return out
