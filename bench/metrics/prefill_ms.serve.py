"""Milliseconds an admission's prefill took: the engine's own
``prefill_seconds`` over its ``prefills`` in the window (host clock, each
ending at the first token's sync)."""


def read(run):
    if run["kind"] != "serve" or not run["prefills"]:
        return None
    return 1e3 * run["prefill_s"] / run["prefills"]
