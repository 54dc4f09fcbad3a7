"""The port's data CLIs — ``python -m pcss_unet_tpu_torch organize``,
``prepare``, ``stats`` and ``check`` — against the JAX package's CLIs on
the same scene, in process: the same printed lines and the same files
(``check split``'s PNGs decode to the codes JAX's Pillow-written ones
hold)."""

import builtins
import filecmp
import json
import os
import re
import sys

import numpy as np
import pytest
from PIL import Image

import pcss_unet_tpu.__main__ as jmain
import pcss_unet_tpu_torch.__main__ as pmain
from pcss_unet_tpu.io.exr import write_exr

H, W, N = 16, 24, 10
LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+ - [A-Z]+ - ")


def _run(main_mod, argv, monkeypatch, capsys):
    """``python -m <package> <argv>`` in process → (exit code, the lines it
    printed, without the logger's timestamped lines)."""
    monkeypatch.setattr(sys, "argv", [main_mod.__name__, *argv])
    try:
        main_mod.main()
        code = 0
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr().out
    return code, "".join(ln for ln in out.splitlines(keepends=True)
                         if not LOG_LINE.match(ln))


def _both(argv_p, argv_j, monkeypatch, capsys):
    got = _run(pmain, argv_p, monkeypatch, capsys)
    want = _run(jmain, argv_j, monkeypatch, capsys)
    return got, want


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    (root / "conditioning_images").mkdir()
    (root / "images").mkdir()
    rng = np.random.default_rng(3)
    for i in range(N):
        chans = {n: rng.standard_normal((H, W)).astype(np.float32) + k
                 for k, n in enumerate("RGBA")}
        write_exr(str(root / "conditioning_images" / f"f{i:02d}.exr"), chans)
        rgb = (rng.random((H, W, 3)) * 255).astype(np.uint8)   # an RGB label
        Image.fromarray(rgb, "RGB").save(root / "images" / f"f{i:02d}.png")
    return root


@pytest.fixture(scope="module")
def organized(scene, tmp_path_factory):
    """The scene split by the port's CLI and by the JAX CLI."""
    out = tmp_path_factory.mktemp("org")
    mp = pytest.MonkeyPatch()
    try:
        for pkg, main_mod in (("p", pmain), ("j", jmain)):
            mp.setattr(sys, "argv", [main_mod.__name__, "organize",
                                     "--scene_dir", str(scene), "--out_dir",
                                     str(out / pkg), "--seed", "7",
                                     "--train_fraction", "0.7"])
            main_mod.main()
    finally:
        mp.undo()
    return out


def _same_tree(a, b):
    for root, _, files in os.walk(a):
        rel = os.path.relpath(root, a)
        other = os.path.join(b, rel)
        assert sorted(files) == sorted(
            f for f in os.listdir(other)
            if os.path.isfile(os.path.join(other, f))), rel
        for f in files:
            assert filecmp.cmp(os.path.join(root, f), os.path.join(other, f),
                               shallow=False), os.path.join(rel, f)


def test_organize_cli_equals_jax(scene, organized, tmp_path, monkeypatch, capsys):
    _same_tree(organized / "p", organized / "j")
    assert len(os.listdir(organized / "p" / "train")) == 14    # 7 pairs
    argv = ["organize", "--scene_dir", str(scene), "--out_dir"]
    (code_p, out_p), (code_j, out_j) = _both(
        argv + [str(tmp_path / "p")], argv + [str(tmp_path / "j")],
        monkeypatch, capsys)
    assert code_p == code_j == 0 and out_p == out_j == "train: 8  val: 2\n"
    # --replace_exr_from: the same count, the same files
    argv = ["organize", "--scene_dir", str(scene), "--replace_exr_from",
            str(scene / "conditioning_images"), "--out_dir"]
    (code_p, out_p), (code_j, out_j) = _both(
        argv + [str(tmp_path / "p" / "val")], argv + [str(tmp_path / "j" / "val")],
        monkeypatch, capsys)
    assert out_p.replace(str(tmp_path / "p"), "") == \
        out_j.replace(str(tmp_path / "j"), "")
    assert "replaced 2 EXR files" in out_p
    _same_tree(tmp_path / "p", tmp_path / "j")


@pytest.mark.parametrize("extra", [[], ["--layout", "nchw"],
                                   ["--per_file", "--per_file_normalize",
                                    "minmax"]],
                         ids=["nhwc", "nchw", "per_file"])
def test_prepare_and_stats_cli_equal_jax(organized, tmp_path, monkeypatch,
                                         capsys, extra):
    src = organized / "p"
    outs = {}
    for pkg, main_mod in (("p", pmain), ("j", jmain)):
        outs[pkg] = _run(main_mod, ["prepare", "--train_dir", str(src / "train"),
                                    "--val_dir", str(src / "val"), "--out_dir",
                                    str(tmp_path / pkg), "--num_workers", "2",
                                    *extra], monkeypatch, capsys)
        outs[pkg] = (outs[pkg], _run(main_mod, ["stats", "--dataset_path",
                                                str(tmp_path / pkg), "--chunk",
                                                "3"], monkeypatch, capsys))
    (prep_p, stats_p), (prep_j, stats_j) = outs["p"], outs["j"]
    assert prep_p == prep_j and prep_p[0] == 0
    assert stats_p == stats_j and stats_p[1].count("channel") == 4
    # every artifact equal: packs, metas, per-file exports, stats
    for f in sorted(os.listdir(tmp_path / "p")):
        p, j = tmp_path / "p" / f, tmp_path / "j" / f
        if f.endswith(".npy"):
            got = np.load(p, allow_pickle=True)
            want = np.load(j, allow_pickle=True)
            if f.endswith("_stats.npy"):
                got, want = got.item(), want.item()
                for k in ("means", "stds"):
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
            else:
                assert np.array_equal(got, want), f
        elif f.endswith(".json"):
            with open(p) as a, open(j) as b:
                assert json.load(a) == json.load(b), f
        else:
            for g in sorted(os.listdir(p)):       # {split}_files/*.npz
                a, b = np.load(p / g), np.load(j / g)
                for k in ("input", "label"):
                    assert np.array_equal(a[k], b[k])


def test_check_channels_equals_jax(organized, tmp_path, monkeypatch, capsys):
    d = tmp_path / "d"
    d.mkdir()
    rng = np.random.default_rng(0)
    write_exr(str(d / "a_input.exr"), {n: rng.random((8, 8)).astype(np.float32)
                                       for n in "RGBA"})
    write_exr(str(d / "b_input.exr"), {n: rng.random((8, 8)).astype(np.float32)
                                       for n in "RGB"})       # no alpha: WARN
    write_exr(str(d / "c_input.exr"), {n: rng.random((8, 8)).astype(np.float32)
                                       for n in "RA"})        # FAIL
    (d / "d_input.exr").write_bytes(b"garbage")              # FAIL
    argv = ["check", "channels", str(d), str(organized / "p" / "train")]
    (code_p, out_p), (code_j, out_j) = _both(argv, argv, monkeypatch, capsys)
    assert code_p == code_j == 1
    lines_p, lines_j = out_p.splitlines(), out_j.splitlines()
    assert lines_p[-1] == lines_j[-1] == "9/11 files satisfy the 4-channel contract"
    # the FAIL lines carry each codec's own error text for the garbage file
    assert [ln.split(":")[0] for ln in lines_p] == [ln.split(":")[0] for ln in lines_j]
    assert [ln for ln in lines_p if "garbage" not in ln and "d_input" not in ln] == \
        [ln for ln in lines_j if "garbage" not in ln and "d_input" not in ln]
    argv = ["check", "channels", str(organized / "p" / "val")]
    (code_p, out_p), (code_j, out_j) = _both(argv, argv, monkeypatch, capsys)
    assert code_p == code_j == 0 and out_p == out_j


def test_check_pair_compare_decodes_equals_jax(organized, monkeypatch, capsys):
    val = organized / "p" / "val"
    stem = sorted(os.listdir(val))[0].rsplit("_", 1)[0]
    argv = ["check", "pair", "--exr", str(val / f"{stem}_input.exr"), "--png",
            str(val / f"{stem}_gt.png"), "--compare_decodes"]
    (code_p, out_p), (code_j, out_j) = _both(argv, argv, monkeypatch, capsys)
    assert code_p == code_j == 0
    assert out_p == out_j
    assert "decode A/B" in out_p and "differs" in out_p     # an RGB label


def test_check_split_png_codes_equal_jax(organized, tmp_path, monkeypatch,
                                         capsys):
    exr = organized / "p" / "train" / sorted(
        f for f in os.listdir(organized / "p" / "train")
        if f.endswith(".exr"))[0]
    (code_p, out_p), (code_j, out_j) = _both(
        ["check", "split", "--exr", str(exr), "--out_dir", str(tmp_path / "p")],
        ["check", "split", "--exr", str(exr), "--out_dir", str(tmp_path / "j")],
        monkeypatch, capsys)
    assert code_p == code_j == 0
    assert out_p.replace(str(tmp_path / "p"), "") == \
        out_j.replace(str(tmp_path / "j"), "")
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "A.png", "B.png", "G.png", "R.png"]
    for name in names:
        got = Image.open(tmp_path / "p" / name)
        want = Image.open(tmp_path / "j" / name)
        assert got.mode == want.mode == "L"
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_check_packs_report_equals_jax(organized, tmp_path, monkeypatch,
                                       capsys):
    src = organized / "p"
    _run(pmain, ["prepare", "--train_dir", str(src / "train"), "--val_dir",
                 str(src / "val"), "--out_dir", str(tmp_path / "d"),
                 "--layout", "nchw"], monkeypatch, capsys)
    argv = ["check", "packs", "--dataset_path", str(tmp_path / "d"),
            "--max_samples", "3", "--report"]
    (code_p, out_p), (code_j, out_j) = _both(
        argv + [str(tmp_path / "p.json")], argv + [str(tmp_path / "j.json")],
        monkeypatch, capsys)
    assert code_p == code_j == 0
    assert out_p.replace("p.json", "") == out_j.replace("j.json", "")
    with open(tmp_path / "p.json") as a, open(tmp_path / "j.json") as b:
        assert json.load(a) == json.load(b)


def test_check_plots_where_matplotlib_is_importable(organized, tmp_path,
                                                    monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    src = organized / "p"
    _run(pmain, ["prepare", "--train_dir", str(src / "train"), "--val_dir",
                 str(src / "val"), "--out_dir", str(tmp_path / "d")],
         monkeypatch, capsys)
    code, out = _run(pmain, ["check", "packs", "--dataset_path",
                             str(tmp_path / "d"), "--max_samples", "2",
                             "--histogram", str(tmp_path / "h.png")],
                     monkeypatch, capsys)
    assert code == 0 and "wrote histograms" in out
    assert Image.open(tmp_path / "h.png").size[0] > 0
    val = src / "val"
    stem = sorted(os.listdir(val))[0].rsplit("_", 1)[0]
    code, out = _run(pmain, ["check", "pair", "--exr", str(val / f"{stem}_input.exr"),
                             "--png", str(val / f"{stem}_gt.png"), "--figure",
                             str(tmp_path / "m.png")], monkeypatch, capsys)
    assert code == 0 and "wrote channel montage" in out
    assert os.path.exists(tmp_path / "m.png")


@pytest.mark.parametrize("flag", ["--histogram", "--figure"])
def test_check_plots_without_matplotlib_exit_naming_it(organized, tmp_path,
                                                       monkeypatch, capsys,
                                                       flag):
    """Where matplotlib is not installed, the plot flags exit with a
    message that names it, and skip nothing silently."""
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **k)

    val = organized / "p" / "val"
    stem = sorted(os.listdir(val))[0].rsplit("_", 1)[0]
    if flag == "--histogram":
        np.save(tmp_path / "train_inputs.npy", np.zeros((2, 4, 4, 4), np.float32))
        argv = ["check", "packs", "--dataset_path", str(tmp_path),
                "--histogram", str(tmp_path / "h.png")]
    else:
        argv = ["check", "pair", "--exr", str(val / f"{stem}_input.exr"),
                "--figure", str(tmp_path / "m.png")]
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.setattr(sys, "argv", [pmain.__name__, *argv])
    with pytest.raises(SystemExit) as e:
        pmain.main()
    assert "matplotlib" in str(e.value.code) and flag in str(e.value.code)
    assert not any(f.endswith(".png") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("command", ["organize", "prepare", "stats", "check",
                                     "temporal"])
def test_data_commands_take_the_jax_flags(monkeypatch, capsys, command):
    """``--help`` lists the JAX CLI's flags: the host-only data commands
    add none (no ``--device``), ``temporal`` adds ``--device``."""
    helps = []
    for main_mod in (pmain, jmain):
        monkeypatch.setattr(sys, "argv", [main_mod.__name__, command, "--help"])
        with pytest.raises(SystemExit) as e:
            main_mod.main()
        assert e.value.code == 0
        helps.append(capsys.readouterr().out)
    mine, theirs = [set(w.strip("[],") for w in h.split() if w.startswith(("--", "[--")))
                    for h in helps]
    if command == "temporal":
        assert mine == theirs | {"--device"}
    else:
        assert mine == theirs and "--device" not in helps[0]


def test_scene_to_mask_on_the_cpu(organized, tmp_path, monkeypatch, capsys):
    """organize → prepare → stats → train → infer, every step through
    ``python -m pcss_unet_tpu_torch``; ``infer --weights`` takes the
    training run's checkpoint directory (its best checkpoint), and the
    EMA parameters with ``--ema``, as the reference-named export of the
    same state gives them."""
    from pcss_unet_tpu_torch.train.checkpoint import export_reference_checkpoint

    src, proc = organized / "p", tmp_path / "proc"
    for argv in (["prepare", "--train_dir", str(src / "train"), "--val_dir",
                  str(src / "val"), "--out_dir", str(proc)],
                 ["stats", "--dataset_path", str(proc)]):
        assert _run(pmain, argv, monkeypatch, capsys)[0] == 0
    (tmp_path / "cfg.ini").write_text(
        "[base]\nbase_width=4\nbatch_size=2\nnum_epochs=1\nwarmup_epochs=1\n"
        f"log_dir={tmp_path / 'logs'}\nsave_dir={tmp_path / 'ck'}\n"
        f"processed_data_dir={proc}\nema_decay=0.5\n")
    monkeypatch.setattr(sys, "argv", [pmain.__name__, "train", "--config",
                                      str(tmp_path / "cfg.ini"),
                                      "--allow_random_vgg", "--device", "cpu"])
    result = pmain.main()
    assert len(result.history) == 1          # its checkpoint is the best
    export_reference_checkpoint(result.state, str(tmp_path / "final.npz"))
    frame = src / "val" / sorted(f for f in os.listdir(src / "val")
                                 if f.endswith(".exr"))[0]
    codes = {}
    for name, weights in (("dir", tmp_path / "ck"), ("npz", tmp_path / "final.npz"),
                          ("ema", tmp_path / "ck")):
        code, out = _run(pmain, ["infer", "--input", str(frame), "--output",
                                 str(tmp_path / f"{name}.png"), "--weights",
                                 str(weights), "--stats_dir", str(proc),
                                 "--dtype", "float32", "--device", "cpu",
                                 *(["--ema"] if name == "ema" else [])],
                         monkeypatch, capsys)
        assert code == 0 and "wrote" in out
        codes[name] = np.asarray(Image.open(tmp_path / f"{name}.png"))
    assert codes["dir"].shape == (H, W)
    assert np.array_equal(codes["dir"], codes["npz"])
    assert not np.array_equal(codes["ema"], codes["dir"])
