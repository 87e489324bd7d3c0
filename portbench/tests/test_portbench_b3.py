"""EfficientLab-b3's joint cell on the CPU: the blocked reference step
against `train.joint_step`, bit for bit; a small run of
`joint-train.b3-1000` through `run.run_cell`, correct under its own limits
and not correct with either of its driver's faults planted; the
configuration file against the tests' b3 variant; and the head's roofline
reader, its counts against the tensors' sizes and the model's decoder
plane."""
import math
import os

import pytest
import torch

from portbench import common, run
from portbench.reference import joint_blocked
from portbench.reference import train as ref
from portbench.reference.model import Arch, Forward, make_weights
from portbench.tests.variants import B3

WORKLOAD = "joint-train.b3-1000"
CONFIG = "efficientlab-b3-joint1000"
# One checked step at 76^2 (planes 38, 19, 10, 5, odd as 300^2's are), as
# the b3 case of test_portbench_reference.py checks it.
SMALL = {"image_size": 76, "model": {"n_classes": 16},
         "joint": {"batch_size": 8},
         "data": {"classes": 16, "train_classes": 12}}
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_the_configuration_holds_the_b3_variant():
    model = common.load_json("configs", CONFIG + ".json")["model"]
    assert {k: model[k] for k in B3} == B3


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("size", [64, 76])
@pytest.mark.parametrize("backbone", ["b0", "b3"])
def test_the_blocked_step_equals_the_joint_step(backbone, size, chunks,
                                                monkeypatch):
    """The loss and every weight after one step, under torch.equal; with
    three chunks the batch of 6 is cut into chunks of 2, as a smaller
    MAX_ELEMENTS cuts it."""
    cfg = common.load_json("configs", "efficientlab-b0-joint1000.json")
    cfg = dict(cfg, model=dict(cfg["model"], n_classes=16,
                               **(B3 if backbone == "b3" else {})))
    arch = Arch.from_config(cfg)
    n = 6
    if chunks > 1:
        monkeypatch.setattr(ref, "MAX_ELEMENTS",
                            (n // chunks) * arch.out_channels * size * size)
    g = torch.Generator().manual_seed(11)
    w0 = make_weights(arch, g, "cpu")
    images, masks = common.render_tasks([0, 1, 2], 2, size, g)
    images = images.reshape(n, size, size, 3)
    labels = (masks.reshape(n, size, size) > 127).to(torch.int32) * \
        torch.arange(1, n + 1, dtype=torch.int32)[:, None, None]
    seeds = torch.randint(0, 2 ** 31 - 1, (n,), generator=g,
                          dtype=torch.int32)
    state = g.get_state()
    out = []
    for step in (ref.joint_step, joint_blocked.joint_step):
        w = {k: v.clone() for k, v in w0.items()}
        gen = torch.Generator()
        gen.set_state(state)
        out.append((step(arch, w, images, labels, seeds, gen, 0.005), w))
    (loss_a, wa), (loss_b, wb) = out
    assert torch.equal(loss_a, loss_b)
    assert set(wa) == set(wb)
    for k in wa:
        assert torch.equal(wa[k], wb[k]), k
    assert any(not torch.equal(wa[k], w0[k]) for k in ref.params_of(w0))


def checked_step(then=None):
    """A `prepare` that checks one step, then runs `then(cell)`."""
    def prepare(cell):
        cell.traffic = dict(cell.traffic, check_steps=1)
        if then is not None:
            then(cell)
    return prepare


def small_run(prepare):
    return run.run_cell(run.cell_spec(WORKLOAD), SEED, 0.5, False,
                        torch.device("cpu"), SMALL, prepare)


def test_a_sound_small_b3_run_is_correct_under_its_limits():
    spec = run.cell_spec(WORKLOAD)
    assert spec["limits"], "the cell has a limits file"
    result = small_run(checked_step())
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(spec["limits"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_b3_timed_path_is_not_correct(fault, monkeypatch):
    spec = run.cell_spec(WORKLOAD)

    def plant(cell):
        run.driver_module(spec).FAULTS[fault](cell, monkeypatch.setattr)

    result = small_run(checked_step(plant))
    assert not result["correct"], result["compared"]


def head_reader():
    return run.load_module(os.path.join(common.ROOT, "metrics",
                                        "head_roofline_pct.joint_b3.py"),
                           "head_roofline_pct_joint_b3")


@pytest.mark.parametrize("size", [76, 300])
def test_the_head_counts_agree_with_the_models_decoder_plane(size):
    """The plane the counts assume is the reference's low logits' at b3;
    the bytes are the tensors' the two launches move."""
    m = head_reader()
    cfg = common.load_json("configs", CONFIG + ".json")
    arch = Arch.from_config(dict(cfg, model=dict(cfg["model"],
                                                 n_classes=4)))
    w = make_weights(arch, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        low, _ = Forward(arch, w, False, None)(
            torch.zeros(1, size, size, 3), upsample=False)
    plane = m.decoder_plane(size)
    assert tuple(low.shape[2:]) == (plane, plane)
    b, c = 3, 5
    size_of = lambda t: t.numel() * t.element_size()  # noqa: E731
    logits = torch.zeros(b, c, plane, plane)
    labels = torch.zeros(b, size, size, dtype=torch.int32)
    stats = torch.zeros(b, size, size, 2)
    assert m.head_bytes(b, c, size) == 3 * size_of(logits) + \
        size_of(labels) + 2 * size_of(stats)
    assert m.head_exps(b, c, size) == 2 * b * c * size * size


def test_the_head_roofline_reads_both_launches_a_step():
    m = head_reader()
    device = [("void resized_ce_forward_kernel<int>(FwdArgs<int>)", 0.0,
               4.0),
              ("resized_ce_backward_kernel(BwdArgs)", 5.0, 11.0),
              ("other_kernel", 11.0, 40.0),
              ("void resized_ce_forward_kernel<int>(FwdArgs<int>)", 40.0,
               44.0),
              ("resized_ce_backward_kernel(BwdArgs)", 45.0, 51.0)]
    trace = common.Trace(device=device, host=[], wall_s=60e-6,
                         inner_steps=2, augment_batch=4, image_size=12)
    channels = common.load_json("configs", CONFIG + ".json")["model"][
        "n_classes"] + 1
    assert math.isclose(m.read(trace),
                        100 * m.least_s(4, channels, 12) / 10e-6)
    assert m.read(common.Trace(device=device[2:3], host=[], wall_s=1.0,
                               inner_steps=2, augment_batch=4,
                               image_size=12)) is None
