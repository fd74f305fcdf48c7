"""Device-idle ms a training step inside the program's ``train.step`` spans:
the gaps in the union of kernel and copy intervals that fall inside a step,
over the ``train.steps`` counter, from the pass with the program's recorder
on (``benchmark/program.py``); None where the trace holds no step."""

from benchmark import program


def read(trace):
    pt = getattr(trace, "program", None)
    steps = pt.counters.get("train.steps", 0) if pt is not None else 0
    return program.idle_ms(pt, "train.step") / steps if steps else None
