"""Host syncs a training step: the syncs that the program's recorder
charges to a ``train.step`` span or a span inside one (``torch.cuda.
set_sync_debug_mode``'s warnings), over the ``train.steps`` counter
(``benchmark/program.py``); None where the trace holds no step."""

from benchmark import program


def read(trace):
    pt = getattr(trace, "program", None)
    steps = pt.counters.get("train.steps", 0) if pt is not None else 0
    return float(program.syncs_under(pt, "train.step")) / steps if steps else None
