"""The comparison that decides ``correct``.

After the window the harness takes the program's state (``s0``), asks the
program for a few more steps through the window's own call (the probe:
``traffic["probe"]``, one kind a step, "fresh" for a step that sorts or
bins anew, "frozen" for a step on the last sort's cells) and takes the
state again (``s1``). The plain reference (``portbench/reference``)
follows the probe from ``s0`` on a sample of rows drawn from the seed:
each step's accelerations in float64 from the benchmark's masses, at the
positions the program stepped to, and the Verlet step's drift and kicks.
Every number is a gap between what the program produced and what the
reference works out, beside a limit read from ``limits/<workload>.json``:

* ``start_gap``: the state the program holds after set-up against the
  inputs handed to it (exact: 0);
* ``steps_gap``: the program's simulation time after the probe against
  float32 time advanced by dt once for each step the harness asked for,
  in steps (exact: 0);
* ``acc_gap``: the accelerations the probe's last step left in the state
  and, where the window's last step binned anew
  (``traffic["last_step"] == "fresh"``), those the window left: the
  largest per-row gap (less the row's band of cutoff-ambiguous pairs)
  over the largest reference acceleration of the rows compared;
* ``pos_gap``: the positions after the probe, the largest gap of a
  coordinate in float32 spacings at the largest coordinate compared;
* ``vel_gap``: the velocities after the probe, the largest gap of a
  component over one step's kick of the largest acceleration (dt·|a|).

The probe's first step starts from the program's ``s0``: where the
window's last step was frozen (its cells are the program's, from a sort
the harness does not see), the reference takes ``s0``'s accelerations as
the program left them; a frozen probe step takes its cells from the
positions the first step drifted to, by the step's own float32 formula.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

SAMPLE_ROWS = 32768


def sample_rows(n: int, seed: int, count: int = SAMPLE_ROWS) -> torch.Tensor:
    """``count`` distinct rows drawn from the seed (sorted, CPU int64)."""
    g = torch.Generator()
    g.manual_seed((int(seed) * 2654435761 + 97) % (1 << 63))
    return torch.sort(torch.randperm(n, generator=g)[:min(count, n)]).values


def reference(name: str):
    """The reference module a configuration's ``reference`` names."""
    return importlib.import_module(f"portbench.reference.{name}")


def drift32(pos, vel, acc, dt: float) -> torch.Tensor:
    """A Verlet step's drift in float32, x + v·dt + (½dt²)·a: the
    positions a sort bins (the cells of the frozen steps after it)."""
    return pos + vel * dt + (0.5 * dt * dt) * acc


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float64)


def follow(s0: dict, end_pos, mass, targets, sim: dict, ref: str,
           kinds: list, start_known: bool, control: bool = False) -> dict:
    """The reference's run of the probe on the rows ``targets``, from the
    program's state ``s0`` (pos, vel, acc; all rows) to the program's
    positions after it, ``end_pos`` → {acc0 (the reference's at ``s0``
    where ``start_known``, else None), pos, vel, acc (after the probe),
    ok (rows comparable in every evaluation), band (the largest band)}.

    ``control``: the reference in the program's place one precision
    below the configuration's float32: the far field's products on TF32
    operands and the state held in bfloat16 after each step."""
    if not kinds or kinds[0] != "fresh" or len(kinds) > 2:
        raise ValueError(f"a probe is a fresh step and at most one more, "
                         f"not {kinds}")
    mod = reference(ref)
    precision = "tf32" if control else "f64"
    dt = float(sim["dt"])
    t = targets
    x = s0["pos"][t].to(torch.float64)
    v = s0["vel"][t].to(torch.float64)
    ok = torch.ones(t.shape[0], dtype=torch.bool, device=x.device)
    band = torch.zeros(t.shape[0], dtype=torch.float64, device=x.device)
    acc0 = None
    if start_known:
        acc0, ok0, band0, _ = mod.accelerations(s0["pos"], mass, t, sim,
                                                precision=precision)
        a = acc0.to(torch.float64)
        ok, band = ok & ok0, torch.maximum(band, band0.to(torch.float64))
    else:
        a = s0["acc"][t].to(torch.float64)
    if control:
        x, v = _bf16(x), _bf16(v)
    grid = None
    for k, kind in enumerate(kinds, 1):
        here = end_pos if k == len(kinds) else drift32(
            s0["pos"], s0["vel"], s0["acc"], dt)
        if kind == "fresh":
            grid = here
        a_new, ok_k, band_k, _ = mod.accelerations(
            here, mass, t, sim, precision=precision,
            grid_pos=None if grid is here else grid)
        a_new = a_new.to(torch.float64)
        x = x + v * dt + (0.5 * dt * dt) * a
        v = v + (0.5 * dt) * (a + a_new)
        if control:
            x, v = _bf16(x), _bf16(v)
        a = a_new
        ok, band = ok & ok_k, torch.maximum(band, band_k.to(torch.float64))
    return {"acc0": acc0, "pos": x, "vel": v, "acc": a, "ok": ok,
            "band": band}


def _acc_gap(got, want, band, ok) -> float:
    diff = torch.linalg.vector_norm(got.to(torch.float64) - want, dim=1)
    diff = torch.clamp(diff - band, min=0.0)[ok]
    scale = torch.linalg.vector_norm(want, dim=1)[ok].max()
    return float(diff.max() / scale)


def _spacing(x: float) -> float:
    """The float32 spacing at |x|."""
    y = torch.tensor(abs(x), dtype=torch.float32)
    return float(torch.nextafter(y, torch.tensor(float("inf"))) - y)


def gaps(got: dict, ref: dict, dt: float) -> tuple:
    """({acc_gap, pos_gap, vel_gap}, rows compared) of ``got`` (acc0 or
    None, pos, vel, acc at the sampled rows: the program's, or the
    control's) against ``follow``'s ``ref``."""
    ok = ref["ok"]
    acc = _acc_gap(got["acc"], ref["acc"], ref["band"], ok)
    if ref["acc0"] is not None:
        acc = max(acc, _acc_gap(got["acc0"], ref["acc0"].to(torch.float64),
                                ref["band"], ok))
    # positions and velocities: rows with no cutoff-ambiguous pair
    rows = ok & (ref["band"] == 0)
    xr, vr = ref["pos"][rows], ref["vel"][rows]
    dx = (got["pos"][rows].to(torch.float64) - xr).abs().max()
    dv = (got["vel"][rows].to(torch.float64) - vr).abs().max()
    kick = dt * torch.linalg.vector_norm(ref["acc"][rows], dim=1).max()
    return ({"acc_gap": acc,
             "pos_gap": float(dx) / _spacing(float(xr.abs().max())),
             "vel_gap": float(dv / kick)}, int(rows.sum()))


def float32_time(steps: int, dt: float) -> float:
    """Simulation time after ``steps`` float32 additions of dt."""
    t, d = np.float32(0.0), np.float32(dt)
    for _ in range(steps):
        t = np.float32(t + d)
    return float(t)


def steps_gap(time: float, steps: int, dt: float) -> float:
    return abs(time - float32_time(steps, dt)) / dt


def start_gap(held: dict, given: dict) -> float:
    """Largest absolute difference between the state held and the inputs."""
    return max(float((held[k].float() - given[k].float()).abs().max())
               for k in given)


def judge(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] in a fixed order; every number needs a limit."""
    return [(k, float(numbers[k]), float(limits[k]["limit"]))
            for k in sorted(numbers)]
