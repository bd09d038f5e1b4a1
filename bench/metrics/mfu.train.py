"""The training window's model FLOPs (``harness.flops.train_flops_per_token``:
6 × the matrix parameters a token uses plus causal attention, no
recomputation) over the window's seconds at the chip's bf16 peak, %."""
from harness import flops


def read(run):
    if run["kind"] != "train" or not run["tokens"]:
        return None
    per = flops.train_flops_per_token(run["config"], run["mix"]["seq_len"])
    return 100.0 * per * run["tokens"] / (run["window_s"] * flops.PEAK_BF16_FLOPS)
