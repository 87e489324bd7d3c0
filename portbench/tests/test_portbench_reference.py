"""The reference against the program at a small size on the CPU, and runs
of the harness with the timed path broken underneath, which `correct` has
to catch. The drivers that no cell uses yet (meta-training, evaluation)
have no limits: their readings have to separate a broken path from a sound
one. The card's control test runs at the cell's own size on the chip
(`portbench/control.py`, PERF.md) and here only where a card is."""
import dataclasses

import pytest
import torch

from portbench import common, control, run
from portbench.reference import train as ref
from portbench.reference.model import Arch, Forward, make_weights

SMALL = {
    "meta-train.b0": {"image_size": 64, "model": {"compute_dtype": "float32"},
                      "meta": {"inner_iters": 3, "meta_batch": 2},
                      "data": {"train_tasks": 6}},
    "joint-train.b0-1000": {"image_size": 64, "model": {"n_classes": 16},
                            "joint": {"batch_size": 8},
                            "data": {"classes": 16, "train_classes": 12}},
    "kshot-eval.b0": {"image_size": 64, "chunk": 2,
                      "model": {"compute_dtype": "float32"},
                      "eval": {"inner_iters": 3}, "data": {"test_tasks": 8}},
}
SEED = 2 ** 31 + 77
# Cells of drivers that BENCHMARK.json does not list yet (PERF.md, Open
# questions).
UNLISTED = {
    "meta-train.b0": {"name": "meta-train.b0", "chips": 1,
                      "config": "efficientlab-b0-meta",
                      "traffic": "meta_train"},
    "kshot-eval.b0": {"name": "kshot-eval.b0", "chips": 1,
                      "config": "efficientlab-b0-meta",
                      "traffic": "kshot_eval"},
}


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def spec_of(workload):
    return run.cell_spec(workload, UNLISTED.get(workload))


def small_run(workload, prepare=None):
    spec = spec_of(workload)
    return run.run_cell(spec, SEED, 0.5, False, torch.device("cpu"),
                        SMALL[workload], prepare)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_reference_forward_equals_the_programs(dtype):
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    arch = dataclasses.replace(Arch.from_config(common.load_json(
        "configs", "efficientlab-b0-meta.json")), compute_dtype=dtype)
    g = torch.Generator().manual_seed(3)
    w = make_weights(arch, g, "cpu")
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=dtype)
    common.load_port_weights(model, w)
    images = torch.rand(4, 64, 64, 3, generator=g) * 255
    for train in (False, True):
        ga, gb = (torch.Generator().manual_seed(5) for _ in range(2))
        with torch.no_grad():
            la, _ = model(images, train=train, generator=ga)
            lb, _ = Forward(arch, {k: v.clone() for k, v in w.items()},
                            train, gb)(images)
        assert torch.equal(la, lb)


def test_reference_meta_step_follows_the_programs_chained_step():
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import learners
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    cfg = common.load_json("configs", "efficientlab-b0-meta.json")
    arch = Arch.from_config(cfg)
    g = torch.Generator().manual_seed(3)
    images, masks = common.render_tasks([0, 1, 2], 10, 64, g)
    counts = torch.full((3,), 10, dtype=torch.int32)
    w = make_weights(arch, g, "cpu")
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    common.load_port_weights(model, w)
    m = dict(cfg["meta"], inner_iters=3, meta_batch=2)
    mc = learners.MetaTrainConfig(num_shots=10, inner_batch_size=8,
                                  inner_iters=3, meta_batch_size=2,
                                  foml=True, tail_shots=5, aug_rate=0.5)
    opt = il.OptimizerConfig("sgd")
    step = learners.make_chained_train_step(model, il.LossConfig(), opt, mc)
    seed = 987654321
    new = step(il.init_model_state(model, opt), images, masks,
               learners.draw_meta_step(seed, counts, mc, 10), 0.1, 5e-4)
    r = ref.meta_step(arch, {k: v.clone() for k, v in w.items()}, images,
                      masks, counts, seed, m, 0.1, 5e-4)
    for k, v in new.params.items():
        torch.testing.assert_close(v, r[k], rtol=1e-5, atol=1e-6)
    for k, v in new.batch_stats.items():
        torch.testing.assert_close(v, r[k], rtol=1e-5, atol=1e-5)


def test_a_sound_small_run_is_correct():
    result = small_run("joint-train.b0-1000")
    assert result["correct"], result["compared"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    spec = spec_of("joint-train.b0-1000")

    def prepare(cell):
        run.driver_module(spec).FAULTS[fault](cell, monkeypatch.setattr)

    result = small_run("joint-train.b0-1000", prepare)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("workload,fault", [
    ("meta-train.b0", "unchanged"), ("meta-train.b0", "half_batch"),
    ("kshot-eval.b0", "unchanged"), ("kshot-eval.b0", "altered_answer")])
def test_an_unlisted_drivers_readings_catch_a_broken_path(workload, fault):
    spec = spec_of(workload)
    assert spec["limits"] == {}

    def read(fault):
        out = control.readings(spec, [SEED], [], 0.5, SMALL[workload],
                               torch.device("cpu"), fault)
        return out["program"][SEED]

    sound, broken = read(None), read(fault)
    assert any(broken[n] > 1e-2 and broken[n] > 100 * sound[n]
               for n in sound), (sound, broken)


@pytest.mark.card
def test_control_fails_and_the_program_passes_on_the_card():
    """The joint cell at a reduced size on the card: the program's numbers
    within the limits, the control's (the reference under TF32) not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    small = {"model": {"n_classes": 100}, "joint": {"batch_size": 16},
             "data": {"classes": 100, "train_classes": 75}}
    out = control.readings(run.cell_spec("joint-train.b0-1000"), [11], [11],
                           0.0, small, torch.device("cuda"))
    limits = run.cell_spec("joint-train.b0-1000")["limits"]
    assert all(v <= limits[n] for n, v in out["program"][11].items()
               if n in limits)
    assert any(v > limits[n] for n, v in out["control"][11].items()
               if n in limits)
