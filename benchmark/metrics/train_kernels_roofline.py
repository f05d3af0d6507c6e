"""K2 + K3 + K4's share of their roofline: their frozen least time for one
step (`work/<config>.py`), times the traced steps, over the device time of
the stse_train kernels in the trace."""

from benchmark.metrics import common

LAYER = "K2-K4 train kernels"
UNIT = "%"
MOVES = "train_windows_per_s"
KERNELS = ("fwd_pre", "fwd_stats", "fwd_sums", "fwd_apply", "projector_", "graph_operand",
           "bwd_", "product_", "sum_splits")


def read(ctx):
    seconds = common.device_s(ctx["trace"], KERNELS)
    work = ctx["work"]
    if seconds <= 0 or not hasattr(work, "train_kernels_bound_s"):
        return None
    r = ctx["config"]["reference"]
    bound = work.train_kernels_bound_s(ctx["config"], r["dataset_batch_size"], r["ghost_size"],
                                       ctx["peaks"])
    return 100.0 * bound * ctx["units"] / seconds
