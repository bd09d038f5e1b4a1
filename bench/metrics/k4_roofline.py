"""The prefill attention kernel K4 (``csrc/flash_attention_wgmma.cu``,
``fa_wgmma_kernel``) against its roofline: the least time the traced
span's prefills need (``harness.flops.k4_bound_s``, each at its prompt's
own length) over the kernel's device time in the span, %."""
from harness import flops

KERNEL = "fa_wgmma_kernel"


def read(run):
    tr = run.get("trace")
    if run["kind"] != "serve" or tr is None or not run["traced_prefills"]:
        return None
    spent = tr.kernel_s(KERNEL)
    if not spent:
        return None
    return 100.0 * flops.k4_bound_s(run["config"], run["traced_prefills"]) / spent
