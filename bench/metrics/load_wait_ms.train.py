"""Milliseconds a training step waited for its batch: the input
pipeline's consumer-side wait (``InputPipeline.stats.t_wait``) over the
window, a step."""


def read(run):
    if run["kind"] != "train" or not run["steps"]:
        return None
    return 1e3 * run["t_wait_s"] / run["steps"]
