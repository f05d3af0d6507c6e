"""The benchmark's tests run whole cells on the CPU, several test processes
at once: one intra-op thread each keeps them from crowding the host's
cores, so that a run's window serves what it is meant to serve."""

import torch

torch.set_num_threads(1)
