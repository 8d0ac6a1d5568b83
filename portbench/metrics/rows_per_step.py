"""Serving engine: decode rows over the window's engine steps (the rows
each executor decode call ran, over the engine's step counter)."""


def read(run, name):
    c = run.counters
    steps = c.get("engine_steps")
    return c["decode_rows"] / steps if steps else None
