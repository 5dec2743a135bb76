"""The port's command line (``cli.py``, ``__main__.py``) on the CPU
(``--device cpu``), on Cornell written with ``testing.write_scene_files``
at 16^2, 4 spp, 2 bounces: ``render`` (both PNGs, resume, ``--watch``,
``--profile``, ``--mesh 1,1``, ``config.ini``), ``info`` against the JAX
CLI's JSON (every key but ``accel``), ``set``/``get``, ``optimize`` (the
loss falls; the ini is written back unless ``--dry-run``), ``bench``
(JSON lines) and the refusal to run without a card unless asked."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.cli import main
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
from ensem3a_openclraytracer_tpu_torch.scene.config import ConfigReader
from ensem3a_openclraytracer_tpu_torch.utils.image import load_png, save_png
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

RES, SPP, MB = 16, 4, 2
CPU = ["--device", "cpu"]
WAIT_S = 120  # every wait on the --watch thread ends by this deadline


@pytest.fixture()
def scene(tmp_path, monkeypatch):
    """Cornell as .obj + .ini in a temporary directory, which is also the
    working directory (the CLI keeps ./config.ini there)."""
    monkeypatch.chdir(tmp_path)
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    path = str(tmp_path / "cornell.obj")
    tt.write_scene_files(path, g, m, e, c, resolution=RES, spp=SPP, max_bounce=MB)
    return path


def _ini(path):
    return path[:-len(".obj")] + ".ini"


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_render_writes_both_pngs(scene, tmp_path, capsys):
    out = str(tmp_path / "o" / "out.png")
    assert main(["render", scene, "--out", out, "--tonemap", "gamma", *CPU]) == 0
    text = capsys.readouterr().out
    assert f"rendered {RES}x{RES} @ {SPP} spp" in text and "Mrays/s" in text
    img, src = load_png(out), load_png(str(tmp_path / "o" / "src.png"))
    assert img.shape == src.shape == (RES, RES, 3)
    assert img.mean() > src.mean() > 0.0  # the gamma encode brightens; src is the clamp


def test_render_resumes_from_its_checkpoint(scene, tmp_path, capsys):
    ckpt = str(tmp_path / "r.npz")
    args = ["render", scene, "--out", str(tmp_path / "a.png"), "--chunk-spp", "2",
            "--checkpoint", ckpt, *CPU]
    assert main(args) == 0
    assert main(args + ["--spp", "8"]) == 0
    text = capsys.readouterr().out
    assert "resumed at 4 spp" in text and "rendered 16x16 @ 8 spp" in text
    with np.load(ckpt) as z:
        assert int(z["spp_done"]) == 8


def test_info_matches_the_jax_cli(scene, capsys):
    from ensem3a_openclraytracer_tpu.cli import build_parser as j_parser

    assert main(["info", scene, *CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    j_args = j_parser().parse_args(["info", scene])
    assert j_args.fn(j_args) == 0
    ref = json.loads(capsys.readouterr().out)
    assert got.pop("accel") == "morton-blocks"
    ref.pop("accel")
    assert got == ref
    assert got["triangles"] == 36 and got["emissive_faces"] == 2


def test_set_get_round_trip(scene, capsys):
    assert main(["set", scene, "spp", "33", *CPU]) == 0
    capsys.readouterr()
    assert main(["get", scene, "spp", *CPU]) == 0
    assert capsys.readouterr().out.strip() == "33"
    assert ConfigReader(_ini(scene)).render_settings().spp == 33


def test_config_ini_keeps_foreign_keys(scene, tmp_path):
    with open("config.ini", "w") as f:
        f.write("theme=dark\nscenePath=/nowhere/old.obj\nlastExport=out.png\n")
    assert main(["render", scene, "--out", str(tmp_path / "a.png"), *CPU]) == 0
    with open("config.ini") as f:
        lines = f.read().splitlines()
    assert lines == ["theme=dark", f"scenePath={os.path.abspath(scene)}", "lastExport=out.png"]
    # and a render without a scene takes the remembered one
    assert main(["render", "--out", str(tmp_path / "b.png"), *CPU]) == 0
    assert os.path.exists(tmp_path / "b.png")


def test_watch_rerenders_when_the_ini_changes(scene, tmp_path):
    out = str(tmp_path / "w" / "out.png")
    result = {}

    def run():
        result["rc"] = main(["render", scene, "--spp", "2", "--max-bounce", "1", "--out", out,
                             "--watch", "1", "--watch-poll", "0.1", *CPU])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + WAIT_S
    while not os.path.exists(out) and time.time() < deadline:
        time.sleep(0.05)
    assert os.path.exists(out), "the first render never finished"
    first = _read(out)
    time.sleep(0.3)
    ConfigReader(_ini(scene)).setParameter("M_0_roughness", "40.0")  # a brighter light
    t.join(timeout=WAIT_S)
    assert not t.is_alive(), "the watch loop did not stop after one re-render"
    assert result.get("rc") == 0
    assert _read(out) != first, "no re-render happened"
    assert os.path.exists(tmp_path / "w" / "src.png")


def test_profile_writes_a_trace(scene, tmp_path, capsys):
    prof = str(tmp_path / "trace")
    assert main(["render", scene, "--spp", "2", "--out", str(tmp_path / "p.png"),
                 "--profile", prof, "--verbose", *CPU]) == 0
    with open(os.path.join(prof, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    text = capsys.readouterr().out
    assert f"torch trace -> {prof}" in text and "stages:" in text and "2/2 spp" in text


def test_render_mesh_1_1_equals_the_plain_render(scene, tmp_path):
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert main(["render", scene, "--out", a, "--seed", "3", *CPU]) == 0
    assert main(["render", scene, "--out", b, "--seed", "3", "--mesh", "1,1", *CPU]) == 0
    assert np.array_equal(load_png(a), load_png(b))


def _target(scene, path):
    """The scene with a darker red wall, rendered at 64 spp."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    m = m._replace(color=m.color.clone().index_put_((torch.tensor(2),),
                                                    torch.tensor([0.2, 0.05, 0.05])))
    gen = torch.Generator().manual_seed(1)
    save_png(torch.clamp(render_radiance(g, m, e, c, gen, height=RES, width=RES, spp=64,
                                         max_bounce=MB, sun_enabled=False), 0.0, 1.0), path)


def _losses(text):
    return [float(line.split()[-1]) for line in text.splitlines() if line.startswith("iter")]


def test_optimize_lowers_the_loss_and_writes_the_ini_back(scene, tmp_path, capsys):
    target = str(tmp_path / "target.png")
    _target(scene, target)
    before = ConfigReader(_ini(scene)).material_table(6)
    fitted = str(tmp_path / "fit.png")
    assert main(["optimize", scene, "--target", target, "--iters", "3", "--lr", "0.1",
                 "--spp", "4", "--max-bounce", str(MB), "--out", fitted, *CPU]) == 0
    text = capsys.readouterr().out
    losses = _losses(text)
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert "wrote fitted parameters back" in text and os.path.exists(fitted)
    after = ConfigReader(_ini(scene)).material_table(6)
    assert after[2, 1] < before[2, 1]  # the red wall's red moved toward the target


def test_optimize_dry_run_leaves_the_ini_and_resumes(scene, tmp_path, capsys):
    target = str(tmp_path / "target.png")
    _target(scene, target)
    ini = _read(_ini(scene))
    ckpt = str(tmp_path / "opt.npz")
    args = ["optimize", scene, "--target", target, "--spp", "2", "--max-bounce", "1",
            "--checkpoint", ckpt, "--checkpoint-every", "1", "--dry-run", *CPU]
    assert main(args + ["--iters", "2"]) == 0
    assert main(args + ["--iters", "3"]) == 0
    text = capsys.readouterr().out
    assert _read(_ini(scene)) == ini and "wrote fitted" not in text
    assert [line.split()[1] for line in text.splitlines() if line.startswith("iter")] == [
        "0", "1", "2"]
    with np.load(ckpt) as z:
        assert int(z["iteration"]) == 3


def test_optimize_refuses_a_target_of_another_size(scene, tmp_path):
    target = str(tmp_path / "t.png")
    save_png(np.zeros((8, 8, 3), np.float32), target)
    with pytest.raises(SystemExit, match="target is 8x8, render is 16x16"):
        main(["optimize", scene, "--target", target, *CPU])


def test_bench_prints_json_lines(capsys):
    assert main(["bench", "--resolution", "16", "--spp", "2", *CPU]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["metric"] for x in lines] == ["cornell_forward_mrays_per_s",
                                            "cornell_fwdbwd_mrays_per_s",
                                            "cornell_train_step_mrays_per_s", "first_call_seconds"]
    for x in lines[:3]:
        assert x["unit"] == "Mrays/s" and x["value"] > 0 and x["device"] == "cpu"
        assert "vs_baseline" not in x and x["card"] is None
    first = lines[3]
    assert first["unit"] == "s" and all(first[k] > 0 for k in ("forward", "fwdbwd", "train_step"))
    assert first["device"] == "cpu" and first["card"] is None


def test_bench_scaling_in_one_process_prints_the_one_rank_record(tmp_path, capsys):
    out = str(tmp_path / "scaling.jsonl")
    assert main(["bench", "--scaling", "--resolution", "16", "--spp", "2", "--out", out,
                 *CPU]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["metric"] for x in lines] == ["scaling_nranks1_mrays_per_s"]
    assert lines[0]["efficiency"] == 1.0 and lines[0]["value"] > 0
    with open(out) as f:
        assert [json.loads(x) for x in f] == lines


@pytest.mark.parametrize("argv", [["render"], ["info"], ["get", "spp"], ["bench"]],
                         ids=lambda a: a[0])
def test_without_device_and_card_the_cli_raises(scene, monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cmd = [argv[0]] + ([] if argv[0] == "bench" else [scene]) + argv[1:]
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        main(cmd)


def test_python_dash_m_runs_the_cli(scene):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    run = lambda *a: subprocess.run([sys.executable, "-m", "ensem3a_openclraytracer_tpu_torch",
                                     *a], capture_output=True, text=True, env=env, timeout=120)
    ok = run("get", scene, "resolution", *CPU)
    assert ok.returncode == 0 and ok.stdout.strip() == str(RES)
    refused = run("get", scene, "resolution")
    assert refused.returncode != 0 and "CUDA was requested" in refused.stderr
