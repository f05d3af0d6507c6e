"""Each traffic generator is deterministic from the seed; the request sizes
are the mix's alone, the same for every seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, program
from benchmark.reference import stse as ref
from benchmark.tests.small import SMALL


def _config(name):
    return harness.Cell(name).config


def test_windows_weights_and_center_repeat_from_the_seed():
    config = _config("flagship-train")
    small = harness.merged(config, SMALL["config"])
    arch = ref.arch_of(small)
    seed = 2 ** 31 + 12345  # seeds run past 32 signed bits
    dev = torch.device("cpu")
    for stream, make in ((0, lambda g: program.windows(96, small, g, dev)),
                         (1, lambda g: torch.cat([t.flatten() for t in ref.make_params(
                             arch, g, dev, trained=True).values()])),
                         (2, lambda g: program.center(arch["latent"], g, dev))):
        a = make(program.generator(seed, dev, stream))
        b = make(program.generator(seed, dev, stream))
        c = make(program.generator(seed + 1, dev, stream))
        assert torch.equal(a, b) and not torch.equal(a, c)
    x = program.windows(96, small, program.generator(seed, dev, 0), dev)
    assert x.shape == (96, 3, 12, 18)
    assert float(x[:, :2].min()) >= -1 and float(x[:, :2].max()) <= 1
    assert float(x[:, 2].min()) >= 0


def test_request_sizes_are_the_mix_alone():
    cell = harness.Cell("hrstc-requests")
    a = harness.load_module(cell.kind.__file__, "k").request_sizes(cell.mix, 12)
    b = cell.kind.request_sizes(cell.mix, 12)
    assert a == b and len(a) == cell.mix["pool"]
    # 240-1,200 frames, 1-6 actors, tracks over 50-100% of the clip
    assert min(a) >= 1 * (120 - 11) and max(a) <= 6 * (1200 - 11)
    assert 1000 < np.mean(a) < 3000


def test_requests_walk_the_same_pool_in_a_seeded_order():
    cell = harness.Cell("hrstc-requests", SMALL)
    runs = [cell.kind.Run(cell, s, torch.device("cpu")) for s in (3, 3, 4)]
    for r in runs:
        r.setup()
    assert runs[0].sizes == runs[1].sizes == runs[2].sizes
    assert list(runs[0].order) == list(runs[1].order)
    assert sorted(runs[0].order) == sorted(runs[2].order)
    for p, q in zip(runs[0].payloads, runs[1].payloads):
        assert np.array_equal(p, q)


def test_training_feed_is_fits_own():
    """The three checked steps are fit's epoch-0 batches, rows all distinct."""
    cell = harness.Cell("flagship-train", SMALL)
    run = cell.kind.Run(cell, 9, torch.device("cpu"))
    run.setup()
    n = run.n_items
    perm = np.random.default_rng((9, 0)).permutation(n)
    assert np.array_equal(run.checked.numpy().ravel(), perm[:run.checked.numel()])
    assert len(set(run.checked.numpy().ravel())) == run.checked.numel()


@pytest.mark.parametrize("key", ("clients", "loop"))
def test_a_mix_key_its_kind_does_not_read_is_refused(key):
    """A mix is data for one kind: a key the kind never reads (more
    clients, an open loop) would give the same cell silently."""
    harness.Cell("hrstc-requests")
    with pytest.raises(harness.BenchError, match=key):
        harness.Cell("hrstc-requests", {"mix": {"clip_requests": {key: 4}}})


def test_checked_requests_hold_the_longest_and_repeat_from_the_seed():
    cell = harness.Cell("hrstc-requests", SMALL)
    run = cell.kind.Run(cell, 3, torch.device("cpu"))
    run.setup()
    run.window(0.2)
    served = {i for i, _ in run.served}
    picked = run.checked()
    assert len(picked) == min(cell.mix["checked_requests"], len(served))
    assert set(picked) <= served and len(set(picked)) == len(picked)
    assert picked[0] == max(served, key=lambda i: (run.sizes[i], i))
    assert picked == run.checked()
