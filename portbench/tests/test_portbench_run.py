"""``portbench/run.py`` run as a command, in a subprocess: no result
without a card or without the program; on the card (marked ``cuda``) every
cell runs correct, and the control fails at the cells' own size.

On the card: ``python -m pytest portbench/tests -m cuda``."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import core

ROOT = str(core.ROOT)
RUN = os.path.join("portbench", "run.py")


def _run(args, cwd=ROOT, env=None, timeout=600):
    return subprocess.run([sys.executable, RUN, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _cells():
    return [c["name"] for c in core.manifest()["workloads"]]


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = _run(["--workload", "bh1m-sphere.run", "--seed", "1",
              "--seconds", "1", "--trace", "0"], env=env)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from portbench import core; "
            "core.run('bh1m-sphere.run', 1, 0.01, False, time.perf_counter(),"
            " device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "nbody_tpu_torch" in p.stderr


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_each_cell_runs_correct_on_the_card(workload):
    _card()
    p = _run(["--workload", workload, "--seed", str(2 ** 31 + 101),
              "--seconds", "2", "--trace", "0"])
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_the_control_fails_at_full_size_on_the_card(workload):
    _card()
    from portbench import control

    rec = control.readings(workload, 2 ** 31 + 202, 1.0, time.perf_counter())
    limits = core.load_json("limits", workload)
    assert rec["correct"]
    for name in ("acc_gap", "pos_gap", "vel_gap"):
        assert rec["control_" + name] > limits[name]["limit"], name
