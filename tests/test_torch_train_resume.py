"""Resume across packages: `repro_torch.launch.train --resume` continues a
checkpoint that `repro.launch.train` wrote, and the other way round, on
the CPU.

Each run trains 4 steps at ``--smoke`` and writes step 2 on the way; the
other package resumes that step 2 and must end within 1e-2 of the first
run's loss (the LM float rule of tests/test_torch_train.py). The params
come from the checkpoint, never from either package's init, and the
batches are the data plane's, element for element in both.
"""
import shutil

import jax  # noqa: F401  -- both packages in one process, JAX on the CPU
import pytest

import repro.launch.train as jtrain_launch
from repro_torch.ckpt import latest_step
from repro_torch.launch import train as train_launch

CPU = "cpu"
LOSS_ABS = 1e-2

CLI = ["--smoke", "--seq-len", "24", "--batch", "2", "--corpus-chars", "6000",
       "--doc-len", "1000", "--steps", "4", "--ckpt-every", "2",
       "--log-every", "4"]


def _step_2_only(src, dst):
    """A checkpoint directory holding `src`'s step 2 alone, so that a
    --resume there continues from it."""
    shutil.copytree(src / "step_00000002", dst / "step_00000002")
    return dst


@pytest.mark.parametrize("arch", ["minicpm-2b", "kimi-k2-1t-a32b"])
def test_port_resumes_a_reference_checkpoint(arch, tmp_path, capsys):
    """`repro.launch.train` runs 4 steps and writes step 2 on the way; the
    port resumes step 2 and ends within 1e-2 of the reference's loss (the
    params come from the checkpoint, not from either init). kimi-k2's
    bf16 embedding and Adafactor state included; the port writes its own
    checkpoints of it too."""
    want = jtrain_launch.main(["--arch", arch, "--ckpt-dir",
                               str(tmp_path / "ref")] + CLI)
    resume = _step_2_only(tmp_path / "ref", tmp_path / "port")
    got = train_launch.main(["--arch", arch, "--ckpt-dir", str(resume),
                             "--resume", "--device", CPU] + CLI)
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(got["steps"]) == 2
    assert abs(got["loss"] - want["loss"]) < LOSS_ABS, (got, want)
    assert latest_step(str(resume)) == 4


def test_reference_resumes_a_port_checkpoint(tmp_path, capsys):
    """The other way round (float32: the reference cannot restore its own
    bf16 leaves)."""
    want = train_launch.main(["--arch", "minicpm-2b", "--ckpt-dir",
                              str(tmp_path / "port"), "--device", CPU] + CLI)
    resume = _step_2_only(tmp_path / "port", tmp_path / "ref")
    got = jtrain_launch.main(["--arch", "minicpm-2b", "--ckpt-dir",
                              str(resume), "--resume"] + CLI)
    assert "resumed from step 2" in capsys.readouterr().out
    assert abs(got["loss"] - want["loss"]) < LOSS_ABS, (got, want)
