"""The decode attention kernel K6 (``csrc/flash_decode_cluster.cu``,
``fd_cluster_kernel``) against its roofline: the least time the traced
span's decode steps need (``harness.flops.k6_bound_s``, the active rows
over the positions written so far) over the kernel's device time in the
span, %."""
from harness import flops

KERNEL = "fd_cluster_kernel"


def read(run):
    tr = run.get("trace")
    if run["kind"] != "serve" or tr is None or not run["traced_decodes"]:
        return None
    spent = tr.kernel_s(KERNEL)
    if not spent:
        return None
    return 100.0 * flops.k6_bound_s(run["config"], run["traced_decodes"]) / spent
