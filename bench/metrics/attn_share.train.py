"""The training attention kernels' share of the device's busy time in the
traced span of a training window, %: the forward with its log-sum-exp
(``fa_train_fwd_kernel``) and the backward's three kernels (``fa_bwd_``,
``csrc/flash_attention_bwd.cu``) over the span's busy seconds.  None where
none of them ran (a program whose training attention is the masked sdpa's
elementwise passes)."""

KERNELS = ("fa_train_fwd_kernel", "fa_bwd_")


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or tr is None or tr.busy_s <= 0:
        return None
    spent = [s for s in (tr.kernel_s(k) for k in KERNELS) if s]
    if not spent:
        return None
    return 100.0 * sum(spent) / tr.busy_s
