"""``python -m pcss_unet_tpu_torch inspect --device cpu`` against the JAX
package's ``inspect`` on the same INI (``tests/test_cli_tools.py``'s small
net, depth 3, width 8, 64×64), in process: the same ``parameters:`` and
``HBM`` lines; the DOT graph and the latency rows of the port."""

import sys

import jax
import pytest

import pcss_unet_tpu_torch.__main__ as pmain
from pcss_unet_tpu.cli import inspect as jinspect
from pcss_unet_tpu.models import UNet as JUNet

INI = "[base]\nmodel_depth=3\nbase_width=8\nimage_width=64\nimage_height=64\n"


@pytest.fixture
def ini(tmp_path, monkeypatch):
    # the JAX CLI would turn on its on-disk compilation cache under HOME
    monkeypatch.setenv("PCSS_COMPILE_CACHE", "0")
    path = tmp_path / "c.ini"
    path.write_text(INI)
    return path


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.strip().startswith(prefix)]


def test_inspect_matches_the_reference(ini, tmp_path, monkeypatch, capsys):
    # jitted: the same tree as the JAX CLI's eager init, a fraction of its time
    init = JUNet.init
    monkeypatch.setattr(JUNet, "init", lambda self, rngs, *a: jax.jit(
        lambda r: init(self, r, *a))(rngs))
    jinspect.main(["--config", str(ini), "--memory"])
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["pcss_unet_tpu_torch", "inspect",
                                      "--config", str(ini), "--memory",
                                      "--device", "cpu",
                                      "--dot", str(tmp_path / "g.dot"),
                                      "--hlo", str(tmp_path / "g.txt"),
                                      "--latency"])
    report = pmain.main()
    got = capsys.readouterr().out
    for prefix in ("model:", "parameters:", "configured frame:", "HBM"):
        assert _lines(got, prefix) == _lines(want, prefix), prefix
    assert len(_lines(got, "HBM")) == 6
    assert (tmp_path / "g.dot").read_text().startswith("digraph")
    assert "ExportedProgram" in (tmp_path / "g.txt").read_text()
    stages = ["enc_0", "enc_1", "enc_2", "dec_0", "dec_1", "dec_final",
              "full_model"]
    assert [r["stage"] for r in report] == stages
    assert [ln.split()[0] for ln in _lines(got, tuple(stages))] == stages
    assert "flops=" in _lines(got, "full_model")[0]
    assert _lines(got, "float32 convolutions on TF32:") == [
        "  float32 convolutions on TF32: no"]


def test_inspect_without_a_card_raises(ini):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pcss_unet_tpu_torch.cli import inspect as pinspect

    with pytest.raises(RuntimeError, match="CUDA"):
        pinspect.main(["--config", str(ini)])
