"""K1's share of its roofline on an autoencoder's two stacks: the frozen
least time of the encoder's and the decoder's work for one batch of the
config's size (`work/<config>.py::k1_bound_s`), times the traced batches,
over the device time of every `stse_fused*` kernel in the window. Any
kernel of that family that does the two stacks reads the same work. None
where the decoder ran on no K1 launch (the port's `decoder_launches` is
absent or 0): the encoder's kernel alone would be held to both stacks'
work."""

from benchmark.metrics import common

LAYER = "K1 eval kernel"
UNIT = "%"
MOVES = "score_windows_per_s"
KERNELS = ("stse_fused",)


def _decoder_on_k1() -> bool:
    from coskad_tpu_torch.kernels import stse_fused

    counter = getattr(stse_fused, "decoder_launches", None)
    return counter is not None and counter.value > 0


def read(ctx):
    seconds = common.device_s(ctx["trace"], KERNELS)
    work = ctx["work"]
    if seconds <= 0 or not hasattr(work, "k1_bound_s") or not _decoder_on_k1():
        return None
    batch = ctx["config"]["reference"]["dataset_batch_size"]
    return 100.0 * work.k1_bound_s(ctx["config"], batch, ctx["peaks"]) * ctx["units"] / seconds
