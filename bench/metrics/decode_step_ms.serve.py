"""Milliseconds a decode step over the arena took: the engine's own
``decode_seconds`` over its ``decode_steps`` in the window (host clock,
each ending at the next tokens' copy to the host)."""


def read(run):
    if run["kind"] != "serve" or not run["decode_steps"]:
        return None
    return 1e3 * run["decode_s"] / run["decode_steps"]
