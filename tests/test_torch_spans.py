"""The program's spans (`utils/profiling.span`): off, a shared no-op that
opens no range and reads no clock; on (inside `profiling.trace`), one
`joint.step` range a train step holding the spans of its layers, the
step's index its input."""
import gzip
import json
import time

import pytest
import torch

from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as ttrainer
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops import augment_kernels as ak
from mliis_tpu_torch.utils import profiling

STEP_SPANS = ("joint.batch", "augment.light", "model.forward", "loss.head",
              "loss.l2", "joint.backward", "optimizer.apply")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _refuse(*args, **kwargs):
    raise AssertionError("a span opened a range or read a clock")


def test_spans_off_open_nothing_and_read_no_clock(monkeypatch):
    for obj, name in ((torch.autograd, "_record_function_with_args_enter"),
                      (torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (time, "perf_counter"), (time, "time"),
                      (torch.cuda, "Event")):
        monkeypatch.setattr(obj, name, _refuse)
    first = profiling.span("joint.step", 3)
    assert profiling.span("model.forward") is first
    with first:
        pass
    with profiling.spans():
        pass
    with profiling.span("loss.head"):
        assert profiling.spanned("loss.l2")(lambda x: x + 1)(1) == 2


def test_spans_switch_on_inside_their_block_only():
    with profiling.spans():
        with profiling.spans():
            pass
        assert profiling.span("a") is not profiling.span("b")
    assert profiling.span("a") is profiling.span("b")


def _trainer(image_size=32, batch=2):
    store = make_synthetic_store(num_tasks=3, examples_per_task=4,
                                 image_size=image_size, seed=0)
    ds = ttrainer.joint_dataset_from_task_store(store)
    model = EfficientLab(n_classes=ds.num_classes, rsd=(2,),
                         final_layer_dropout_rate=0.2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    config = ttrainer.JointTrainConfig(batch_size=batch, augment=True,
                                       l2=True)
    trainer = ttrainer.JointTrainer(model, ds, ds, config,
                                    til.OptimizerConfig("sgd"), device="cpu",
                                    log_fn=lambda *_: None)
    opt = til.init_opt_state(dict(model.named_parameters()),
                             til.OptimizerConfig("sgd"))
    return trainer, opt


def test_a_traced_train_step_nests_its_layers_in_joint_step(tmp_path):
    trainer, opt = _trainer()
    gen = torch.Generator().manual_seed(1)
    idx = torch.tensor([0, 5])
    seeds = torch.tensor([11, 12], dtype=torch.int32)
    opt, _ = trainer.train_step(opt, idx, seeds, 0.01, gen)   # step 0
    with profiling.trace(str(tmp_path)) as path:
        opt, _ = trainer.train_step(opt, idx, seeds, 0.01, gen)   # step 1
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    (root,) = [e for e in events if e["name"] == "joint.step"]
    start, end = root["ts"], root["ts"] + root["dur"]
    inside = {e["name"] for e in events
              if start <= e["ts"] and e["ts"] + e["dur"] <= end}
    assert set(STEP_SPANS) <= inside
    assert inside - {"joint.step"} == set(STEP_SPANS)

    # The step index is the root range's input, which a profile that
    # records shapes keeps.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof, profiling.spans():
        trainer.train_step(opt, idx, seeds, 0.01, gen)   # step 2
    (root,) = [e for e in prof.events() if e.name == "joint.step"]
    assert root.concrete_inputs == [2]
    assert not [e for e in prof.events() if e.name in STEP_SPANS
                and e.concrete_inputs]


def _augmentation(name):
    """A call of the augmentation wrapper whose span is `name`, on the CPU
    (its plain version)."""
    g = torch.Generator().manual_seed(0)
    seeds = torch.tensor([5, 9], dtype=torch.int32)
    perm = torch.arange(6, dtype=torch.int32).repeat(2, 1)
    num = torch.full((2,), 6, dtype=torch.int32)
    x = torch.rand(2, 5, 16, 16, generator=g) * 255
    if name == "augment.full_pass":
        rot = torch.tensor([[30, 0, 0, 0], [-20, 1, 0, 0]], dtype=torch.int32)
        return lambda: (ak.full_pass(seeds, x, perm, num, rot),)
    if name == "augment.cheap_pass":
        window = torch.tensor([[0, 6], [0, 6]], dtype=torch.int32)
        return lambda: (ak.cheap_pass(seeds, x, perm, num, window),)
    images = torch.rand(2, 16, 16, 3, generator=g) * 255
    masks = (torch.rand(2, 16, 16, generator=g) > 0.5).float()
    return lambda: ak.fused_light_augment(seeds, images, masks)


@pytest.mark.parametrize("name", ["augment.full_pass", "augment.cheap_pass",
                                  "augment.light"])
def test_each_augmentation_wrapper_is_its_span(name):
    """Each wrapper's call is one range of its span's name, holding the
    plain version's ops, with the output it gives with spans off."""
    call = _augmentation(name)
    off = call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            profiling.spans():
        on = call()
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    events = prof.events()
    (rng,) = [e for e in events if e.name == name]
    assert [e for e in events if e.name.startswith("aten::")
            and rng.time_range.start <= e.time_range.start
            and e.time_range.end <= rng.time_range.end]
