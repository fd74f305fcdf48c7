"""Device-idle ms an epoch outside every ``train.step`` span of the program:
the epoch's set-up, its stack and flush, the feed and the epoch's end, over
the segment's ``train.epoch`` spans, from the pass with the program's
recorder on (``benchmark/program.py``); None where the trace holds no
epoch."""

from benchmark import program


def read(trace):
    pt = getattr(trace, "program", None)
    epochs = len(program.intervals(pt, "train.epoch")) if pt is not None else 0
    return program.idle_outside_ms(pt, "train.step") / epochs if epochs else None
