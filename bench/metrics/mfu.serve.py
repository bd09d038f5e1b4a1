"""The serving window's forward FLOPs (``harness.flops``: each prefill at
its prompt's own length, each decode step over its active rows) over the
window's seconds at the chip's bf16 peak, %."""
from harness import flops


def read(run):
    if run["kind"] != "serve" or not (run["prefill_lengths"] or run["decode_rows"]):
        return None
    conf = run["config"]
    work = (sum(flops.prefill_flops(conf, n) for n in run["prefill_lengths"])
            + sum(flops.decode_flops(conf, rows) for rows in run["decode_rows"]))
    return 100.0 * work / (run["window_s"] * flops.PEAK_BF16_FLOPS)
