"""The first-epoch validation AUC of the paper's HR-STC euclidean
configuration: the port's Trainer and the JAX package's from the same
weights and data on the CPU.

On the card the HR-STC files give a first-epoch validation AUC far below
the later epochs' (0.30, then 0.98-0.998). The JAX package shows the same
dip: config/HR-STC/euclidean_encoder.yaml (the MLP projector, the dynamic
center, Adam) read as shipped but for its paths, compute_dtype float32 (XLA
on the CPU has no bf16 dot) and the widths and batch cut to (8, 4, 8), h_dim
16, latent 4, batch 256, over the 17-joint AlphaPose tree of
tests/fixtures.py (400 frames, seed 0): both packages give 0.483 after epoch
one and 0.991 after epoch two. At the shipped widths and batch (1,100
frames) both give 0.582, then 0.996. The dip is the model's, not the port's.

Tolerance: the two packages' AUCs within AUC_TOL = 1e-2 at each epoch. They
start from the same weights and center, but Adam normalises the rounding
noise of the analytically zero gradients (the pre-BN biases) into steps of
+-lr, so the two runs drift apart within the lockstep band (per-step losses
rtol 1e-3, tests/test_torch_train.py) and a frame whose score lies close to
another's can swap ranks. Over the fixture's seeds 0-5 at this cut the
largest difference was 3.0e-3 (seed 3; the others 3e-5 to 8.6e-4), measured
by running this file as a script (`PYTHONPATH=. python tests/test_torch_first_epoch_auc.py`;
`--shipped` gives the full-width figures above).
1e-2 is three times that, and 50 times below the dip's size (0.5).
"""

import os
import re
import sys

import jax
import numpy as np
import torch

from coskad_tpu.cli import common as jcommon
from coskad_tpu.parallel import create_mesh
from coskad_tpu.train.loop import Trainer as JaxTrainer
from coskad_tpu_torch.cli import common
from coskad_tpu_torch.interop import load_jax_variables
from coskad_tpu_torch.train.loop import Trainer
from fixtures import make_synthetic_dataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUC_TOL = 1e-2
# the cut: the shipped file's lines replaced, the rest as shipped
CUT = dict(compute_dtype="float32", channels="[8, 4, 8]", h_dim=16, latent_dim=4,
           dataset_batch_size=256)


def shipped_euclidean(root: str, seed: int, n_frames: int = 400, **edits) -> str:
    """config/HR-STC/euclidean_encoder.yaml over the fixture's 17-joint tree
    in `root`, the paths and `edits` replaced line by line."""
    make_synthetic_dataset(root, n_frames=n_frames, seed=seed)
    with open(os.path.join(ROOT, "config", "HR-STC", "euclidean_encoder.yaml")) as f:
        text = f.read()
    edits = dict(data_dir=root, dataset_path_to_robust=root, test_path=os.path.join(root, "gt"),
                 exp_dir=os.path.join(root, "checkpoints"), **edits)
    for key, value in edits.items():
        text, n = re.subn(rf"^{key}:.*$", f"{key}: {value}", text, flags=re.M)
        assert n == 1, key
    path = os.path.join(root, "euclidean_encoder.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def validation_aucs(cfg_path: str, epochs: int = 2):
    """(JAX's, the port's) validation AUC after each of `epochs` Adam epochs
    of Trainer.fit, both from the JAX Trainer's initial weights and center."""
    jcfg, cfg = jcommon.load_config(cfg_path), common.load_config(cfg_path)
    jtrain = jcommon.load_split(jcfg, "train")
    jval = jcommon.load_split(jcfg, "test", stride=1, scaler=jtrain.scaler)
    train = common.load_split(cfg, "train")
    val = common.load_split(cfg, "test", stride=1, scaler=train.scaler)
    np.testing.assert_array_equal(train.data, jtrain.data)
    jtrainer = JaxTrainer(jcfg, jtrain, jval, jcommon.load_ground_truths(jcfg.data.gt_dir),
                          mesh=create_mesh(1, 1, devices=jax.devices()[:1]))
    jstate = jtrainer.initialize_center(jtrainer.init_state())
    trainer = Trainer(cfg, train, val, common.load_ground_truths(cfg.data.gt_dir), device="cpu")
    load_jax_variables(trainer.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    state = trainer.initialize_center(trainer.init_state())
    jaucs, aucs = [], []
    for _ in range(epochs):
        jstate, jhist = jtrainer.fit(jstate, epochs=1)
        state, hist = trainer.fit(state, epochs=1)
        jaucs += jhist["validation_auc"]
        aucs += hist["validation_auc"]
    return jaucs, aucs


def test_first_epoch_validation_auc_dips_in_both_packages(tmp_path):
    cfg_path = shipped_euclidean(str(tmp_path), seed=0, **CUT)
    cfg = common.load_config(cfg_path)
    assert (cfg.model.projector, cfg.model.variant, cfg.data.n_joints) == (
        "mlp", "euclidean_dynamic", 17)
    jaucs, aucs = validation_aucs(cfg_path)
    assert len(jaucs) == len(aucs) == 2
    assert np.abs(np.subtract(aucs, jaucs)).max() <= AUC_TOL, (jaucs, aucs)
    # the dip, in both: the first epoch's AUC far below the second's
    for run in (jaucs, aucs):
        assert run[0] < 0.6 and run[1] > 0.9, run


if __name__ == "__main__":
    # `PYTHONPATH=. python tests/test_torch_first_epoch_auc.py [seeds]`: the spread over the
    # fixture's seeds at the test's cut; `--shipped`: seed 0 at the file's own
    # widths and batch over 1,100 frames (a few minutes on one core).
    import tempfile

    shipped = "--shipped" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--shipped"]
    for seed in range(1 if shipped else int(args[0]) if args else 6):
        with tempfile.TemporaryDirectory() as root:
            path = (shipped_euclidean(root, seed, n_frames=1100, compute_dtype="float32")
                    if shipped else shipped_euclidean(root, seed, **CUT))
            jaucs, aucs = validation_aucs(path)
        print(f"seed {seed}: jax {jaucs} port {aucs} "
              f"max diff {np.abs(np.subtract(aucs, jaucs)).max():.3e}", flush=True)
