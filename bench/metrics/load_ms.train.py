"""Producer-busy milliseconds a step on the LIRS read path: reading the
batch's records (``read_batch_into``) and decoding them
(``decode_token_batch``), ``InputPipeline.stats.t_load`` over the window,
a step."""


def read(run):
    if run["kind"] != "train" or not run["steps"]:
        return None
    return 1e3 * run["t_load_s"] / run["steps"]
