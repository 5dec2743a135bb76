"""A whole run with the timed path broken underneath comes out not
correct: for renders, half of the samples left out (the mean over the
rest) and each image made from another seed's stream; for steps, a step
that returns its state unchanged, half of the samples left out, a step on
another iteration's stream, and two faults of the graph's replays alone
(every call after the first, which captures): a stale key, the first
step's, and stale inputs, the first step's values and optimizer state.
The sound run comes out correct.
The run skips its look for a card and renders on the CPU at 16^2."""

import json

import pytest

from port_bench import run


def result_of(root, cell, capsys):
    rc = run.main(["--workload", cell, "--seed", "2147483651", "--seconds", "0.3"],
                  device="cpu", root=root, require_card=False)
    out = capsys.readouterr()
    assert rc == 0
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return json.loads(out.out.strip().splitlines()[-1])


def render_fault(kind):
    from ensem3a_openclraytracer_tpu_torch.models import pathtracer

    sound = pathtracer.render_scene

    def broken(scene, seed=0, overrides=None):
        if kind == "half_batch":
            return sound(scene, seed, {"spp": scene.config.render_settings().spp // 2})
        return sound(scene, seed + 1, overrides)  # "altered"

    return broken


@pytest.mark.parametrize("cell", ["cornell.render", "outdoor15k.render", "outdoor15k.tree"])
@pytest.mark.parametrize("fault", [None, "half_batch", "altered"])
def test_render_faults_are_not_correct(tiny_root, capsys, monkeypatch, cell, fault):
    from ensem3a_openclraytracer_tpu_torch.models import pathtracer

    if fault is not None:
        monkeypatch.setattr(pathtracer, "render_scene", render_fault(fault))
    assert result_of(tiny_root, cell, capsys)["correct"] is (fault is None)


def replay_fault(step, kind):
    """``step`` with its calls after the first fed the first call's key
    (``stale_key``) or its values and optimizer state (``stale_inputs``)."""
    first = {}

    def broken(params, opt_state, target, gen):
        if not first:
            first.update(state=gen.get_state(), inputs=(params, opt_state))
        elif kind == "stale_key":
            gen.set_state(first["state"])
        else:
            params, opt_state = first["inputs"]
        return step(params, opt_state, target, gen)

    return broken


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered", "stale_key",
                                   "stale_inputs"])
def test_step_faults_are_not_correct(tiny_root, capsys, monkeypatch, fault):
    from ensem3a_openclraytracer_tpu_torch.models import optimize

    sound_make, sound_gen = optimize.make_train_step, optimize.iteration_generator

    def make(*args, spp, **kw):
        init, step = sound_make(*args, spp=spp // 2 if fault == "half_batch" else spp, **kw)
        if fault in ("stale_key", "stale_inputs"):
            return init, replay_fault(step, fault)
        if fault != "unchanged":
            return init, step

        def still(params, opt_state, target, gen):
            return (params, opt_state) + tuple(step(params, opt_state, target, gen)[2:])

        return init, still

    monkeypatch.setattr(optimize, "make_train_step", make)
    if fault == "altered":
        monkeypatch.setattr(optimize, "iteration_generator",
                            lambda seed, i, device=None: sound_gen(seed, i + 1, device))
    assert result_of(tiny_root, "cornell.optimize", capsys)["correct"] is (fault is None)
