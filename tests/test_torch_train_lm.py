"""``examples/train_lm_torch.py`` on the CPU: the reference example's loop
(``examples/train_lm.py``) at ``--size 3m`` for 52 steps of 8 x 32 tokens
in microbatches of 4, checkpoints every 25 steps and a failure injected at
step 26, against the same run without the failure.

``tests/test_torch_train.py`` already holds the train step itself against
the reference's; this file holds the loop's restart and the example's
wiring: one restart, the replay from the step-25 checkpoint, and every
loss after the restart equal to the uninterrupted run's, bit for bit (the
same seeded weights and seekable batches on the CPU); the loss falls as
the example requires.
"""
import importlib.util
from pathlib import Path

import pytest

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "train_lm_torch.py"
ARGS = ["--size", "3m", "--steps", "52", "--seq", "32", "--device", "cpu"]


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("train_lm_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_restart_replays_the_uninterrupted_losses(example, tmp_path):
    args = example.parse_args(ARGS + ["--ckpt-dir", str(tmp_path / "a")])
    assert (args.batch, args.microbatch, args.lr) == (8, 4, 6e-4)
    model, run = example.build(args)
    assert (run.param_dtype, run.compute_dtype, run.microbatches()) == (
        "float32", "float32", 2)
    assert model.attn_impl == "blocked"
    at = example.fault_step(args)
    assert at == 26
    rep, stats = example.run(args)
    clean, _ = example.run(example.parse_args(
        ARGS + ["--ckpt-dir", str(tmp_path / "b"), "--no-inject-fault"]))
    assert (rep.restarts, clean.restarts) == (1, 0)
    assert rep.steps_done == clean.steps_done == 52
    # steps 0-25 ran, the fault struck at 26 before it ran, the loop
    # restored the step-25 checkpoint and replayed from there
    restored = (at // example.CKPT_EVERY) * example.CKPT_EVERY
    assert restored == 25
    assert len(rep.losses) == at + 52 - restored
    assert rep.losses[:at] == clean.losses[:at]
    assert rep.losses[at:] == clean.losses[restored:]
    assert stats["loss_last10"] < stats["loss_first10"] - example.LOSS_DROP
    assert stats["ckpt_save_s"] > 0 and stats["ckpt_restore_s"] > 0
