"""The port's `ray`, `plot` and `orbit` CLIs (cli/trajectory.py) on the
CPU against the JAX package's.

Each command runs in both packages' CLIs in this process (the JAX one
with its command-line float32 default for `ray` and `plot`; `orbit` in
float64 in both). Criteria: every line the JAX CLI prints appears in the
port's output, with each number equal to the printed precision, except
the Hamiltonian residual, a roundoff-level maximum that must stay below
1e-8 in both; the port's extra lines (the path summaries) are its own.
The figures are written where matplotlib imports, and without it `ray`
and `plot` say that no figure was written and succeed. `orbit` refuses
--eps3 with exit code 2, as JAX's does.
"""

import re
import sys

import jax
import pytest

NUM = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?|-?\d+")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, [line for line in out.splitlines()
                if not line.startswith("Saved:")]


def _jax(argv, capsys, x64=False):
    from light_path_tracer_tpu.cli import main
    with jax.enable_x64(x64):
        return _run(main, argv, capsys)


def _port(argv, capsys):
    from light_path_tracer_tpu_torch.cli import main
    return _run(main, argv + ["--device", "cpu"], capsys)


def _same_numbers(line, other, residual_ok=False):
    a, b = NUM.findall(line), NUM.findall(other)
    if len(a) != len(b) or NUM.sub("#", line) != NUM.sub("#", other):
        return False
    for x, y in zip(a, b):
        if residual_ok and "e" in x:
            if not (float(x) < 1e-8 and float(y) < 1e-8):
                return False
        elif float(x) != float(y) and abs(float(x) - float(y)) > 1.5 * 10.0 ** (
                -len(x.split(".")[-1]) if "." in x else 0):
            return False
    return True


def _assert_covers(jax_lines, port_lines):
    for line in jax_lines:
        residual = line.startswith("Hamiltonian residual")
        assert any(_same_numbers(line, p, residual) for p in port_lines), (
            line, port_lines)


@pytest.mark.parametrize("argv", [
    ["ray", "--no-plot"],
    ["ray", "--no-plot", "--a", "0.9", "--alpha-deg", "5"],
    ["ray", "--no-plot", "--Q", "0.6", "--alpha-deg", "2"]])
def test_ray_prints_jax_numbers(argv, capsys):
    rj, jl = _jax(argv, capsys)
    rp, pl = _port(argv, capsys)
    assert rj == rp == 0
    _assert_covers(jl, pl)
    assert any(line.startswith("Path:") for line in pl)


def test_plot_prints_jax_numbers(tmp_path, capsys):
    argv = ["plot", "--a", "0.9", "--output", str(tmp_path / "p.png")]
    rj, jl = _jax(argv, capsys)
    rp, pl = _port(argv, capsys)
    assert rj == rp == 0
    _assert_covers(jl, pl)
    assert sum(line.startswith("  path alpha") for line in pl) == 10
    assert (tmp_path / "p.png").exists()


@pytest.mark.parametrize("argv", [
    ["orbit", "--no-plot", "--steps", "1200"],
    ["orbit", "--no-plot", "--a", "0.9", "--peri", "10", "--apo", "14",
     "--inclination", "10", "--steps", "1200"]])
def test_orbit_prints_jax_numbers(argv, capsys, tmp_path):
    rj, jl = _jax(argv, capsys, x64=True)
    rp, pl = _port(argv + ["--npz", str(tmp_path / "o.npz")], capsys)
    assert rj == rp == 0
    _assert_covers(jl, pl)
    import numpy as np
    rec = np.load(tmp_path / "o.npz")
    assert rec["periapsis_advance"].size >= 2
    assert np.max(np.abs(rec["hamiltonian"] + 0.5)) < 1e-8


def test_without_matplotlib_and_refusals(monkeypatch, capsys, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc, pl = _port(["ray", "--output", str(tmp_path / "r.png")], capsys)
    assert rc == 0 and "note: matplotlib is not installed" in "\n".join(pl)
    rc, pl = _port(["plot", "--angles", "2,8", "--output",
                    str(tmp_path / "p.png")], capsys)
    assert rc == 0 and "note: matplotlib is not installed" in "\n".join(pl)
    assert not (tmp_path / "r.png").exists()
    from light_path_tracer_tpu_torch.cli import main
    assert main(["orbit", "--eps3", "1", "--device", "cpu"]) == 2
