"""The `disk` subcommand's one-trace modes and `lens --disk` on the CPU
at 16 px: each flag runs end to end through the port's entry points and
writes what its help says (PNGs by the package's own writer, the JAX
package's CSV columns, .npz arrays)."""

import numpy as np
import pytest
import torch

from light_path_tracer_tpu_torch.cli import main
from light_path_tracer_tpu_torch.utils.save import read_png, write_png

COMMON = ["disk", "--size", "16", "--a", "0.9", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_cli_disk_decompose(tmp_path, capsys):
    out = tmp_path / "dec.png"
    assert main(COMMON + ["--decompose", str(out), "--orders", "5"]) == 0
    text = capsys.readouterr().out
    assert "Decomposition: 16x16, a=0.9, 5 orders from ONE trace" in text
    assert "n=4: flux" in text and "flux ratios" in text
    for name in ("composite", "n0", "n1", "n2", "n3", "n4"):
        assert read_png(tmp_path / f"dec_{name}.png").shape == (16, 16, 3)
    data = np.load(tmp_path / "dec.npz")
    assert data["layers"].shape == (5, 16, 16)
    assert data["flux_per_order"][0] > data["flux_per_order"][1] > 0


def test_cli_disk_frames(tmp_path, capsys):
    out = tmp_path / "f.png"
    assert main(COMMON + ["--frames", "3", "--spectrum", "blackbody",
                          "--output", str(out)]) == 0
    text = capsys.readouterr().out
    assert "Hot-spot orbit: 3 frames (1.0 orbit(s), period" in text
    for k in range(3):
        assert read_png(tmp_path / f"f_{k:03d}.png").shape == (16, 16, 3)
    data = np.load(tmp_path / "f_frames.npz")
    assert data["times"].shape == data["light_curve"].shape == (3,)
    assert np.ptp(data["light_curve"]) > 0.0
    with pytest.raises(ValueError, match="PNG"):
        main(COMMON + ["--frames", "3", "--output", str(tmp_path / "f.gif")])


def test_cli_disk_aa(tmp_path, capsys):
    out = tmp_path / "aa.png"
    assert main(COMMON + ["--aa", "2", "--output", str(out)]) == 0
    assert "Accretion disk: 16x16" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (16, 16, 3) and img.max() > 0.5


@pytest.mark.parametrize("flag,header,columns", [
    ("--line-profile", "energy,flux", 2),
    ("--light-curve", "time_M,flux", 2),
    ("--qu-loop", "time_M,I,Q,U", 4)])
def test_cli_disk_curves(tmp_path, capsys, flag, header, columns):
    plot = tmp_path / "c.png"
    assert main(COMMON + [flag, str(plot), "--line-bins", "20"]) == 0
    assert f"Saved: {tmp_path / 'c.csv'}" in capsys.readouterr().out
    csv = tmp_path / "c.csv"
    assert csv.read_text().splitlines()[0] == f"# {header}"
    data = np.loadtxt(csv, delimiter=",")
    assert data.shape[1] == columns and np.isfinite(data).all()
    assert data.shape[0] == {"--line-profile": 20, "--light-curve": 32,
                             "--qu-loop": 48}[flag]
    assert not plot.exists()


def test_cli_disk_polarization(tmp_path, capsys):
    out = tmp_path / "p.png"
    assert main(COMMON + ["--polarization", str(out), "--b-field",
                          "vertical", "--Q", "0.3"]) == 0
    text = capsys.readouterr().out
    assert "polarized rendering is Kerr-only; ignoring --Q" in text
    assert "Polarization: 16x16, a=0.9, vertical field" in text
    assert read_png(out).shape == read_png(
        tmp_path / "p_pol_frac.png").shape == (16, 16, 3)
    data = np.load(tmp_path / "p.npz")
    assert set(data.files) == {"evpa", "pol_frac", "intensity"}
    evpa = data["evpa"][np.isfinite(data["evpa"])]
    assert evpa.size > 5 and np.abs(evpa).max() <= np.pi / 2


@pytest.mark.parametrize("extra", [[], ["--aa", "2", "--translucent",
                                        "--spectrum", "powerlaw"]])
def test_cli_lens_disk(tmp_path, capsys, extra):
    src = tmp_path / "src.png"
    write_png(src, np.random.default_rng(1).integers(
        0, 256, (16, 20, 3), dtype=np.uint8))
    out = tmp_path / "l.png"
    assert main(["lens", "--image", str(src), "--disk", "--device", "cpu",
                 "--output", str(out), *extra]) == 0
    text = capsys.readouterr().out
    assert "disk pixels: " in text and "r_isco=" in text
    assert read_png(out).shape == (16, 20, 3)
