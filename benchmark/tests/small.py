"""The small sizes at which the benchmark's tests drive whole runs on the CPU."""

SMALL = {
    "config": {"dataset": {"windows": 256},
               "reference": {"dataset_batch_size": 256, "ghost_size": 64}},
    "mix": {"clip_requests": {"pool": 8, "frames": [24, 60], "trace_requests": 3,
                              "warmup_requests": 2, "checked_requests": 8},
            "score_passes": {"trace_passes": 1, "warmup_passes": 1}},
}
