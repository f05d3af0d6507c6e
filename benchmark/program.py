"""What the traffic kinds share: the port's config from a benchmark config
file, and the inputs, weights and center made on the device from the seed.

The system under test is the port, `coskad_tpu_torch`, imported here and
in the traffic kinds only; the reference (`benchmark/reference`) imports
none of it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import stse as ref


def port_config(config: dict, seed: int):
    """The port's Config from the file's `reference` keys (the reference
    repository's flat config keys, as `config/*/*.yaml` write them), with
    the run's seed."""
    from coskad_tpu_torch.config import from_reference_dict

    return from_reference_dict(dict(config["reference"], seed=seed))


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one input stream of the run's seed."""
    state = np.random.SeedSequence((seed, stream)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def windows(n: int, config: dict, gen: torch.Generator, device) -> torch.Tensor:
    """n normalized pose windows [n, C, T, V] in one draw: x and y uniform
    in [-1, 1] (the symmetric range the reference's normalization gives),
    the confidence uniform in [0, 1]."""
    arch = ref.arch_of(config)
    c = int(config["dataset"]["channels"])
    u = torch.rand(n, c, arch["frames"], arch["joints"], generator=gen, device=device)
    u[:, :2] = u[:, :2] * 2.0 - 1.0
    return u


def segment_dataset(data: torch.Tensor, num_transform: int):
    """The port's SegmentDataset over windows made on the device (its API
    takes host arrays; the Trainer puts them on the device once)."""
    from coskad_tpu_torch.data.windows import SegmentDataset

    n, _, t, _ = data.shape
    return SegmentDataset(data=data.cpu().numpy(), meta=np.zeros((n, 4), np.int64),
                          frame_ids=np.zeros((n, t), np.int32), num_transform=num_transform)


def load_weights(model, params: dict) -> None:
    """Every parameter and BatchNorm statistic of the model, by name; a name
    either side lacks is an error."""
    model.load_state_dict({k: v.to(next(model.parameters()).device) for k, v in params.items()},
                          strict=True)


def center(latent: int, gen: torch.Generator, device) -> torch.Tensor:
    """A served model's center, as a checkpoint would carry it."""
    return (torch.rand(latent, generator=gen, device=device) - 0.5).contiguous()


def route() -> dict:
    """The port's kernel launch counters: which route ran."""
    from coskad_tpu_torch.kernels import stse_fused, stse_train

    return {"K1": stse_fused.launches.value, "K2": stse_train.forward_launches.value,
            "K3": stse_train.layer_backward_launches.value,
            "K4": stse_train.top_backward_launches.value,
            "K5": stse_train.mono_backward_launches.value}


def build_kernels(config: dict, device) -> None:
    """Compile (or find built) the port's kernels the config runs, all at
    once, before anything is timed."""
    if device.type == "cuda" and config.get("kernels"):
        from coskad_tpu_torch.kernels import build

        build.build_all(config["kernels"])
