"""Device kernels launched a training step: the kernels in the traced epoch
over its steps (copies not counted). What a CUDA-graph capture or a fusion
of the host loop lowers."""

LAYER = "device"
UNIT = "launches"
MOVES = "train_windows_per_s"


def read(ctx):
    return len(ctx["trace"].kernels) / ctx["units"]
