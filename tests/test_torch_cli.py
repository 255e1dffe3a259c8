"""nbody_tpu_torch CLI against the JAX package's (CPU): the same argv
through both ``parse_app_cli_options``, ``to_config()`` compared field by
field, the same rejections, the usage text and the exit codes."""

import dataclasses
import re

import pytest
import torch

import nbody_tpu.cli as jcli
import nbody_tpu.errors as jerr
import nbody_tpu_torch.cli as tcli
from nbody_tpu.ops.forces import list_algorithms as jlist
from nbody_tpu_torch.errors import ValidationError
from nbody_tpu_torch.ops.forces import list_algorithms as tlist

ACCEPTED = [
    [],
    ["12345"],
    ["--particles", "5000", "--method", "barnes-hut", "--dt", "0.01",
     "--gravity", "2.0", "--softening", "0.2", "--theta", "0.7",
     "--cell-size", "1.5", "--cutoff", "3.0", "--seed", "7"],
    ["--method", "bh", "--init", "sphere"],
    ["--method", "hash", "--hash-engine", "tiles"],
    ["--method", "spatial_hash", "--hash-engine", "window"],
    ["--method", "n2"],
    ["--init", "uniform", "--min-bounds", "-1,-2,-3", "--max-bounds",
     "1,2,3", "--min-mass", "0.5", "--max-mass", "2"],
    ["--init", "spherical", "--center", "1,2,3", "--radius", "4",
     "--min-mass", "1", "--max-mass", "1.5"],
    ["--init", "disk", "--center", "0,0,1", "--radius", "8",
     "--thickness", "0.5", "--rotation-speed", "2", "--min-mass", "0.1",
     "--max-mass", "0.2"],
    ["--init", "plummer", "--center", "1,1,1", "--radius", "2",
     "--total-mass", "3"],
    ["--init", "plummer"],
    ["--resort-every", "8", "--resort-stale-frac", "0.01",
     "--resort-repair", "--method", "barnes-hut"],
    ["--benchmark"],
    ["--benchmark-steps", "50", "--benchmark-output", "b.json"],
    ["--export", "a.nbody", "--export-format", "hdf5", "--import", "b.h5"],
    ["--devices", "2", "--steps", "9", "--debug-nans", "--trace", "t"],
    ["--render-output", "frames", "--live", "--list-algorithms",
     "--diagnostics"],
]


def _fields(obj):
    """Dataclass fields as plain values: enums by name, dist params as a
    (class name, fields) pair."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if hasattr(v, "name") and not isinstance(v, str):
            v = v.name
        elif dataclasses.is_dataclass(v):
            v = (type(v).__name__, _fields(v))
        out[f.name] = v
    return out


@pytest.mark.parametrize("argv", ACCEPTED, ids=lambda a: " ".join(a) or "defaults")
def test_parse_and_config_match_jax(argv):
    """Every option and every ``to_config()`` field equal between the two
    packages (enums by name, dist params by class name and field)."""
    jo = jcli.parse_app_cli_options(argv)
    to = tcli.parse_app_cli_options(argv)
    assert _fields(to) == _fields(jo)
    assert _fields(to.to_config()) == _fields(jo.to_config())


REJECTED = [
    ["--nope"],
    ["--particles"],
    ["--method"],
    ["--method", "fmm"],
    ["--init", "cube"],
    ["--particles", "abc"],
    ["--particles", "0"],
    ["--dt", "2"],
    ["--softening", "-1"],
    ["--theta", "3"],
    ["--gravity", "0"],
    ["--cell-size", "0"],
    ["--cutoff", "-1"],
    ["--hash-engine", "grid"],
    ["--benchmark-steps", "0"],
    ["--export-format", "csv"],
    ["--min-mass", "2", "--max-mass", "1"],
    ["--init", "uniform", "--min-bounds", "1,1,1", "--max-bounds",
     "0,2,2"],
    ["--center", "1,2"],
    ["--radius", "-1"],
    ["--init", "uniform", "--radius", "3"],
    ["--init", "plummer", "--thickness", "1"],
    ["--init", "spherical", "--total-mass", "1"],
]


@pytest.mark.parametrize("argv", REJECTED, ids=" ".join)
def test_rejections_match_jax(argv):
    """The argv lists the JAX parser refuses, the port refuses with its
    own ``ValidationError`` and the same message."""
    with pytest.raises(jerr.ValidationError) as jexc:
        jcli.parse_app_cli_options(argv)
    with pytest.raises(ValidationError) as texc:
        tcli.parse_app_cli_options(argv)
    assert str(texc.value) == str(jexc.value)


def test_usage_lists_every_jax_flag():
    flags = set(re.findall(r"--[a-z][a-z-]*", jcli.app_cli_usage()))
    assert len(flags) >= 39
    assert flags <= set(re.findall(r"--[a-z][a-z-]*", tcli.app_cli_usage()))


def test_main_exit_codes(capsys):
    assert tcli.main(["--help"]) == 0
    assert "Usage: nbody-tpu-torch" in capsys.readouterr().out
    assert tcli.main(["--nope"]) == 2
    assert "Unknown argument: --nope" in capsys.readouterr().err
    assert tcli.main(["--list-algorithms"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name, _ in jlist())
    assert [n for n, _ in tlist()] == [n for n, _ in jlist()]
    assert tcli.main(["--diagnostics"]) == 0
    assert "hdf5 support" in capsys.readouterr().out


def test_main_needs_the_card():
    """Without a card the entry point raises the facade's RuntimeError; it
    never steps on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--particles", "64", "--benchmark-steps", "1"])
