"""K1's share of its roofline: its frozen least time for one launch of the
config's batch (`work/<config>.py`), times its traced launches, over their
device time."""

from benchmark.metrics import common

LAYER = "K1 eval kernel"
UNIT = "%"
MOVES = "score_windows_per_s"
KERNELS = ("stse_fused_kernel",)


def read(ctx):
    seconds = common.device_s(ctx["trace"], KERNELS)
    work = ctx["work"]
    if seconds <= 0 or not hasattr(work, "k1_bound_s"):
        return None
    batch = ctx["config"]["reference"]["dataset_batch_size"]
    launches = common.count(ctx["trace"], KERNELS)
    return 100.0 * work.k1_bound_s(ctx["config"], batch, ctx["peaks"]) * launches / seconds
