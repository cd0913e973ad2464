"""The training launcher's data-parallel mesh on gloo ranks on the CPU.

``--data-axis 2`` on 2 ranks (``torch.distributed.run``) prints the JAX
package's lines and the one-rank losses; its checkpoint, gathered and
written by rank 0, resumes in the one-rank launcher as the one-rank run's own
does; ``--data-axis`` above the ranks there are is refused, with no fallback
to one device.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(args, nproc, tmp_path, timeout=300):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train",
           "--device", "cpu", *args]
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=timeout, cwd=tmp_path)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return proc.stdout


def _losses(text):
    return re.findall(r"step\s+(\d+) loss (\S+)", text)


def test_launcher_data_axis_and_mesh_checkpoint(tmp_path, capsys):
    """--data-axis 2 on 2 gloo ranks prints the reference's lines and the
    one-rank losses; its checkpoint (gathered, written by rank 0) resumes in
    the one-rank launcher as the one-rank run's own does."""
    from repro_torch.launch import train
    args = ["--preset", "smoke", "--steps", "3", "--seq", "32", "--batch", "8",
            "--ckpt-every", "2"]
    out = _launch([*args, "--data-axis", "2", "--ckpt-dir", str(tmp_path / "mesh")],
                  2, tmp_path)
    assert "(0.4M params) on 2 device(s)" in out
    assert out.count("[train] done") == 1            # rank 0 prints
    train.main([*args, "--device", "cpu", "--ckpt-dir", str(tmp_path / "one")])
    one = capsys.readouterr().out
    assert _losses(out) == _losses(one) and len(_losses(one)) == 2
    # resume both from step 2 on one device: the same next loss
    resumed = []
    for d in ("mesh", "one"):
        shutil.rmtree(tmp_path / d / "step_3")
        train.main([*args, "--device", "cpu", "--ckpt-dir", str(tmp_path / d)])
        text = capsys.readouterr().out
        assert "[train] restored step 2" in text
        resumed.append(float(_losses(text)[-1][1]))
    assert abs(resumed[0] - resumed[1]) <= 2e-4, resumed


def test_data_axis_above_the_ranks_is_refused():
    """--data-axis 2 without a second rank raises; nothing falls back to one
    device."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(ValueError, match="--data-axis 2 needs 2 ranks"):
        train(cfg, steps=1, seq=16, batch=2, device="cpu", data_axis=2)
    import torch.distributed as dist
    assert not dist.is_initialized()
