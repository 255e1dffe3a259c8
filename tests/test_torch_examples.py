"""The port's examples (``examples_torch/``) and its 4M flagship
(``scripts/flagship_4m_torch.py``) on the CPU at a tiny size: each
finishes, prints its quantities, and writes its files (the checkpoint,
the CSV, the frames). On the card they run unchanged without
``--device cpu``."""

import importlib.util
from pathlib import Path

import pytest
import torch

from examples_torch import (
    example_basic,
    example_custom_distribution,
    example_energy_conservation,
    example_force_methods,
    example_galaxy_collision,
)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_example_basic(tmp_path, capsys):
    out = tmp_path / "basic.nbody"
    example_basic.main(["300", "20", *CPU, "--out", str(out)])
    text = capsys.readouterr().out
    assert "Initialized 300 particles on cpu" in text
    assert "step 20: t=0.020" in text
    assert "energy drift over 20 steps" in text
    assert "checkpoint round trip OK" in text and out.exists()


def test_example_custom_distribution(capsys, monkeypatch):
    monkeypatch.setattr(example_custom_distribution, "LEVELS", 3)
    example_custom_distribution.main(["400", "1", *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("t=0.010  r_median=")
    assert "z_rms=" in lines[0] and "galaxy evolved" in lines[-1]


def test_example_energy_conservation(tmp_path, capsys):
    out = tmp_path / "drift.csv"
    example_energy_conservation.main(["2000", "1000", *CPU, "--out",
                                      str(out)])
    text = capsys.readouterr().out
    assert "final drift = " in text
    for dt in ("0.001", "0.0005", "0.0001"):
        assert f"dt={dt}: |drift| = " in text
    rows = out.read_text().splitlines()
    assert rows[0] == "step,total_energy,relative_drift"
    assert len(rows) == 3 and rows[-1].startswith("2000,")
    assert abs(float(rows[-1].split(",")[2])) < 1e-4


def test_example_force_methods(capsys, monkeypatch):
    monkeypatch.setattr(example_force_methods, "LEVELS", 3)
    example_force_methods.main(["600", *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["method", "ms/eval", "median", "rel", "err"]
    errs = {ln.split()[0]: float(ln.split("%")[0].split()[-1])
            for ln in lines[1:]}
    assert set(errs) == {"direct-n2", "barnes-hut", "spatial-hash"}
    assert errs["direct-n2"] < 1e-3 and errs["barnes-hut"] < 5.0


def test_example_galaxy_collision(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(example_galaxy_collision, "LEVELS", 3)
    example_galaxy_collision.main(["400", "2", *CPU, "--out",
                                   str(tmp_path)])
    assert f"frames written to {tmp_path}" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "frame_0000.png", "frame_0001.png"]


def test_examples_refuse_a_missing_card(monkeypatch):
    """Without ``--device`` an example means the card, and exits without
    one rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        example_basic.main(["10", "1"])


def test_flagship_on_cpu(tmp_path, capsys, monkeypatch):
    """The flagship's two parts at N = 3000 on the CPU, cut to levels 3,
    2 steps a run and one frame: both print their readings and the last
    line is the JAX script's JSON; the bh part passes its gate and each
    frame is a 960×540 PNG."""
    spec = importlib.util.spec_from_file_location(
        "flagship_4m_torch", REPO / "scripts" / "flagship_4m_torch.py")
    flagship = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flagship)
    monkeypatch.setattr(flagship, "LEVELS", 3)
    monkeypatch.setattr(flagship, "BH_STEPS", 2)
    res = flagship.main([str(tmp_path), "--n", "3000", "--frames", "1",
                         *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == ('{"bh-4m": %s, "galaxy-4m": %s}'
                         % (res["bh-4m"], res["galaxy-4m"]))
    assert any(ln.startswith("bh-4m dense sphere: ") for ln in lines)
    assert any(ln.startswith("galaxy-4m flagship: ") for ln in lines)
    frames = sorted(tmp_path.iterdir())
    assert [p.name for p in frames] == ["frame_0000.png", "frame_0001.png"]
    from chip_smoke import read_png

    img = read_png(str(frames[-1]))
    assert img.shape == (540, 960, 3) and int(img.max()) > 0
