"""Device-idle ms a chunk of the eval loop inside the program's ``eval.h2d``
spans (the chunk's copy to the card), over the ``eval.chunks`` counter, from
the pass with the program's recorder on (``benchmark/program.py``); None
where the trace holds no chunk."""

from benchmark import program


def read(trace):
    pt = getattr(trace, "program", None)
    chunks = pt.counters.get("eval.chunks", 0) if pt is not None else 0
    return program.idle_ms(pt, "eval.h2d") / chunks if chunks else None
