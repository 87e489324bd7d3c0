"""The reference against the program at a small size on the CPU, and runs
of the harness with the timed path broken underneath, which `correct` has
to catch. The drivers that no cell uses yet (meta-training, evaluation)
have no limits: their readings have to separate a broken path from a sound
one. The card's control test runs at the cell's own size on the chip
(`portbench/control.py`, PERF.md) and here only where a card is."""
import pytest
import torch

from portbench import common, control, run
from portbench.reference import train as ref
from portbench.reference.model import Arch, Forward, make_weights
from portbench.tests.variants import B3

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


def shrunk(workload, model=None, size=None):
    """The cell's CPU size, with more `model` keys and another size."""
    small = SMALL[workload]
    return dict(small, image_size=size or small["image_size"],
                model=dict(small["model"], **(model or {})))


def small_run(workload, prepare=None, model=None, size=None):
    return run.run_cell(spec_of(workload), SEED, 0.5, False,
                        torch.device("cpu"), shrunk(workload, model, size),
                        prepare)


@pytest.mark.parametrize("size", [64, 76])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["b0", "b3"])
@pytest.mark.parametrize("config", ["efficientlab-b0-meta",
                                    "efficientlab-b0-joint1000"])
def test_reference_forward_equals_the_programs(config, backbone, dtype,
                                               size):
    """The shipped configurations, and each on EfficientNet-b3; at 76^2 the
    planes go odd (38, 19, 10, 5), as 300^2's do."""
    cfg = common.load_json("configs", config + ".json")
    cfg = dict(cfg, model=dict(cfg["model"], compute_dtype=dtype,
                               **(B3 if backbone == "b3" else {})))
    arch = Arch.from_config(cfg)
    g = torch.Generator().manual_seed(3)
    w = make_weights(arch, g, "cpu")
    model = common.program_model(cfg, "cpu")
    common.load_port_weights(model, w)
    images = torch.rand(4, size, size, 3, generator=g) * 255
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
    cfg = common.load_json("configs", "efficientlab-b0-meta.json")
    arch = Arch.from_config(cfg)
    g = torch.Generator().manual_seed(3)
    images, masks = common.render_tasks([0, 1, 2], 10, 64, g)
    counts = torch.full((3,), 10, dtype=torch.int32)
    w = make_weights(arch, g, "cpu")
    model = common.program_model(cfg, "cpu")
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


# The joint cell's configuration over its three checked steps, and the b3
# one at 76^2 (odd planes) over one, under the same limits: at b3 on the
# CPU, round-off that the three chained steps grow reads a loss gap of
# 1.3e-6-7.1e-6 (the limit 1e-6), while each step agrees with the
# reference from the program's own state (the test after these; PERF.md).
JOINT = [(None, None, 3), (B3, 76, 1)]


def checked_steps(steps, then=None):
    """A `prepare` that checks `steps` steps, then runs `then(cell)`."""
    def prepare(cell):
        cell.traffic = dict(cell.traffic, check_steps=steps)
        if then is not None:
            then(cell)
    return prepare


@pytest.mark.parametrize("model,size,steps", JOINT, ids=["b0", "b3"])
def test_a_sound_small_run_is_correct(model, size, steps):
    result = small_run("joint-train.b0-1000", checked_steps(steps), model,
                       size)
    assert result["correct"], result["compared"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("model,size,steps", JOINT, ids=["b0", "b3"])
def test_a_broken_timed_path_is_not_correct(model, size, steps, fault,
                                            monkeypatch):
    spec = spec_of("joint-train.b0-1000")

    def plant(cell):
        run.driver_module(spec).FAULTS[fault](cell, monkeypatch.setattr)

    result = small_run("joint-train.b0-1000", checked_steps(steps, plant),
                       model, size)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("model", [None, B3], ids=["b0", "b3"])
def test_each_joint_step_follows_the_reference_from_the_programs_state(
        model):
    """Each of the three checked steps at 76^2, taken by the reference from
    the program's parameters before it, with the same batch and draws:
    its loss and its update's worst leaf within the joint cell's limits."""
    spec = spec_of("joint-train.b0-1000")
    limits = spec["limits"]
    cell = run.make_cell(spec, SEED, torch.device("cpu"),
                         shrunk("joint-train.b0-1000", model, 76))
    cell.setup()
    before = cell.w0
    for step, (idx, seeds, state) in enumerate(cell.batches, 1):
        w = {k: v.clone() for k, v in dict(cell.w0, **before).items()}
        g = torch.Generator()
        g.set_state(state)
        loss = float(ref.joint_step(cell.arch, w, cell.images[idx],
                                    cell.labels[idx], seeds, g, cell.lr))
        mine = float(cell.losses[step - 1])
        assert abs(mine - loss) / abs(loss) <= limits["loss_gap"], step
        after = cell.after[step]
        prog = {k: after[k] - before[k] for k in after}
        refd = {k: w[k] - before[k] for k in after}
        gap, leaf = ref.leaf_gap(prog, refd, ref.moving_leaves(refd))
        assert gap <= limits["first_update_gap"], (step, leaf, gap)
        before = after


@pytest.mark.parametrize("key,value", [
    ("backbone", "efficientnet-b1"), ("max_block", 9), ("decoder_dim", 100),
    ("compute_dtype", "float16"), ("aspp", True)])
@pytest.mark.parametrize("workload", ["joint-train.b0-1000", "meta-train.b0",
                                      "kshot-eval.b0"])
def test_a_driver_refuses_what_the_program_would_not_honour(workload, key,
                                                            value):
    """A backbone with no table in the program, a cut or a decoder width
    other than the built model's, a dtype with no name, a key no driver
    reads: each driver raises, naming the key."""
    spec = spec_of(workload)
    cfg = spec["config"]
    spec = dict(spec, config=dict(cfg, model=dict(cfg["model"],
                                                  **{key: value})))
    with pytest.raises(ValueError, match="model." + key):
        run.make_cell(spec, SEED, torch.device("cpu"))


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
