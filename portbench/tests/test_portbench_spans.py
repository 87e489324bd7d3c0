"""The reduction of a span slice (`portbench/spans.py`): device events to
the program's spans, backward work to its forward op's span, idle gaps to
the main thread's span, every kept device event counted once."""
import json
import math
import os

import pytest
import torch

from portbench import common, run, spans
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as jt
from mliis_tpu_torch.meta import inner_loop as il
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops.losses import is_bn_name
from mliis_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _call(ts, correlation, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 0.2, tid=tid,
              correlation=correlation)


def made_up_events():
    """Two steps on thread 1; the backward node of the head's op on thread
    2; kernels on stream 7, an annotation and an overhead row beside
    them. The device is idle on [31, 40) (inside model.forward's ops),
    [52, 60) (inside loss.head) and [100, 130) (between the steps)."""
    step, ev = "joint.step", []
    for base, ext in ((0, 100), (120, 200)):
        ev += [
            _x("user_annotation", step, base, 100, **{"External id": ext}),
            _x("user_annotation", "model.forward", base + 5, 40,
               **{"External id": ext + 1}),
            _x("cpu_op", "aten::conv2d", base + 6, 30,
               **{"External id": ext + 2, "Sequence number": ext}),
            _x("user_annotation", "loss.head", base + 50, 20,
               **{"External id": ext + 3}),
            _x("cpu_op", "aten::upsample_bilinear2d", base + 51, 10,
               **{"External id": ext + 4, "Sequence number": ext + 1}),
            _x("user_annotation", "joint.backward", base + 75, 20,
               **{"External id": ext + 5}),
            _x("cpu_op", spans.EVALUATE + "UpsampleBilinear2DBackward0",
               base + 76, 10, tid=2, **{"External id": ext + 6,
                                        "Sequence number": ext + 1,
                                        "Fwd thread id": 9}),
            _x("cpu_op", "UpsampleBilinear2DBackward0", base + 77, 8, tid=2,
               **{"External id": ext + 7, "Sequence number": ext + 1,
                  "Fwd thread id": 9}),
            _x("cpu_op", "aten::upsample_bilinear2d_backward", base + 78, 6,
               tid=2, **{"External id": ext + 8}),
            _x("cpu_op", "aten::add", base + 84.5, 1, tid=2,
               **{"External id": ext + 9}),
            _x("cpu_op", spans.EVALUATE + "torch::autograd::AccumulateGrad",
               base + 87, 2, tid=2, **{"External id": ext + 10,
                                       "Fwd thread id": 9}),
            # The CUDA calls, each inside the op that makes it, and one
            # inside the span alone (a kernel launched through ctypes).
            _call(base + 7, ext + 50), _call(base + 8, ext + 51),
            _call(base + 52, ext + 52), _call(base + 79, ext + 53, tid=2),
            _call(base + 84.7, ext + 54, tid=2), _call(base + 40, ext + 55),
            # device: conv on [10, 30), the head's forward on [40, 52),
            # its backward [60, 90), the accumulation's add [90, 95), a
            # copy from the forward [95, 100), the span's own kernel on
            # [30.5, 31)
            _x("kernel", "conv", base + 10, 20, correlation=ext + 50),
            _x("kernel", "upsample_fwd", base + 40, 12, correlation=ext + 52),
            _x("kernel", "upsample_bwd", base + 60, 30, correlation=ext + 53),
            _x("kernel", "add", base + 90, 5, correlation=ext + 54),
            _x("gpu_memcpy", "Memcpy HtoD", base + 95, 5,
               correlation=ext + 51),
            _x("kernel", "own", base + 30.5, 0.5, correlation=ext + 55),
            _x("gpu_user_annotation", "loss.head", base + 40, 50,
               **{"External id": ext + 3}),
            _x("overhead", "Command Buffer Full", base + 30, 5),
        ]
    # A kernel no host call launched.
    ev.append(_x("kernel", "stray", 230, 2, correlation=999))
    ev.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": 1})
    return ev


def test_made_up_trace_puts_every_kept_event_down_once():
    table = spans.reduce(made_up_events(), wall_s=240e-6)
    assert table.steps == 2
    assert table.device_us == {"model.forward": 2 * 25.5,
                               "loss.head": 2 * 42.0,
                               "joint.backward": 2 * 5.0,
                               spans.OUTSIDE: 2.0}
    assert math.isclose(sum(table.device_us.values()), table.kept_us)
    assert table.kept_us == 2 * 72.5 + 2
    assert table.launches == {"model.forward": 4, "loss.head": 4,
                              "joint.backward": 2, spans.OUTSIDE: 1}
    assert table.dropped == {"gpu_user_annotation": (2, 100.0),
                             "overhead": (2, 10.0)}
    assert table.device_ms("loss.head") == 42e-3
    assert table.launches_per_step("loss.head", "joint.backward") == 3
    # Gaps: [30, 30.5) and [31, 40) in model.forward; [52, 60) in
    # loss.head; [100, 130) mid 115 outside both steps; the second
    # step's as the first's; [220, 230), before the stray kernel, outside.
    assert table.idle_us == {"model.forward": 2 * 9.5, "loss.head": 16.0,
                             spans.OUTSIDE: 30.0 + 10.0}
    # Idle inside the steps: each step's first 10 us and its inner gaps;
    # none of [100, 120) or of [220, 230) (outside the steps).
    assert table.step_idle_us == 2 * (10 + 9.5 + 8)
    assert math.isclose(table.step_idle_pct(), 100 * 55 / 240)
    rows = {r[0]: r for r in table.rows()}
    assert math.isclose(rows["joint.step"][4], (100 - 40 - 20 - 20) / 1e3)
    assert rows["loss.head"][1] == 42e-3


def _profiled_step(tmp_path):
    """One EfficientLab joint step at 32^2 on the CPU, its spans on: its
    Chrome trace's events and the model's parameters."""
    store = make_synthetic_store(num_tasks=3, examples_per_task=4,
                                 image_size=32, seed=0)
    ds = jt.joint_dataset_from_task_store(store)
    model = EfficientLab(n_classes=ds.num_classes, rsd=(2,))
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = jt.JointTrainer(
        model, ds, ds, jt.JointTrainConfig(batch_size=2, augment=True),
        il.OptimizerConfig("sgd"), device="cpu", log_fn=lambda *_: None)
    opt = il.init_opt_state(dict(model.named_parameters()),
                            il.OptimizerConfig("sgd"))
    gen = torch.Generator().manual_seed(1)
    args = (torch.tensor([0, 5]), torch.tensor([3, 4], dtype=torch.int32),
            0.01, gen)
    trainer.train_step(opt, *args)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            profiling.spans():
        trainer.train_step(opt, *args)
    path = os.path.join(str(tmp_path), "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"], dict(model.named_parameters())


def test_backward_ops_go_to_their_forward_ops_span(tmp_path):
    """With CPU ops standing in for kernels: the head's bilinear backward
    (the first to run) goes to loss.head, the decoder's to model.forward;
    gradient accumulation to joint.backward."""
    events, params = _profiled_step(tmp_path)
    host = spans._Host(events)
    named = lambda n: sorted((e["ts"], i) for i, e in  # noqa: E731
                             enumerate(host.rows) if e["name"] == n)
    (_, head), (_, decoder) = named("aten::upsample_bilinear2d_backward")
    assert host.attribute(head) == "loss.head"
    assert host.attribute(decoder) == "model.forward"
    accumulate = named(spans.EVALUATE + "torch::autograd::AccumulateGrad")
    assert accumulate
    assert {host.attribute(i) for _, i in accumulate} == {"joint.backward"}
    # The forward op and the l2 term's squares keep their own spans.
    (_, fwd), = named("aten::upsample_bilinear2d")[-1:]
    assert host.attribute(fwd) == "loss.head"
    l2 = [host.attribute(i) for _, i in named("aten::square")].count(
        "loss.l2")
    assert l2 == sum(not is_bn_name(k) for k in params)
    (_, root), = named("joint.step")
    assert host.attribute(root) == "joint.step"


NEW = {"head_device_ms.joint", "model_device_ms.joint",
       "update_device_ms.joint", "update_launches_per_step.joint",
       "step_idle_pct.joint"}


def _small_run(monkeypatch, tmp_path, trace):
    """A joint run at 32^2 on the CPU through `run.run_cell`: its result,
    and how many slices it profiled and how many of them with spans."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    calls = {"slices": 0, "spans": 0}
    profile_spans = spans.profile_spans

    def counted(cell):
        calls["spans"] += 1
        return profile_spans(cell)

    monkeypatch.setattr(spans, "profile_spans", counted)

    def prepare(cell):
        cell.traffic = dict(cell.traffic, trace_steps=2)
        whole = cell.trace_slice

        def trace_slice():
            calls["slices"] += 1
            return whole()

        cell.trace_slice = trace_slice

    result = run.run_cell(
        run.cell_spec("joint-train.b0-1000"), 2 ** 31 + 5, 0.2, trace,
        torch.device("cpu"), {"image_size": 32, "model": {"n_classes": 6},
                              "joint": {"batch_size": 2},
                              "data": {"classes": 6, "train_classes": 4}},
        prepare)
    return result, calls


def test_an_untraced_run_has_no_span_table(monkeypatch, tmp_path):
    """Without --trace 1 no slice is profiled; a reader handed a trace
    without a span table finds nothing to read."""
    result, calls = _small_run(monkeypatch, tmp_path, False)
    assert calls == {"slices": 0, "spans": 0}
    assert set(result["metrics"]) == {"joint_images_per_s", "setup_s"}
    trace = common.Trace(device=[], host=[], wall_s=1.0, inner_steps=2,
                         augment_batch=2, image_size=32)
    for name in NEW:
        reader = run.load_module(os.path.join(
            common.ROOT, "metrics", name + ".py"), "reader")
        assert reader.read(trace) is None


def test_a_traced_run_profiles_one_span_slice_for_the_readers(monkeypatch,
                                                              tmp_path):
    """A traced run profiles three slices, the third with spans, and the
    five span metrics read its table; with a program that has no spans
    the third slice is not taken and they are left out."""
    result, calls = _small_run(monkeypatch, tmp_path, True)
    assert calls == {"slices": 3, "spans": 1}
    assert NEW <= set(result["metrics"])
    assert result["metrics"]["update_launches_per_step.joint"][
        "value"] == 0   # no card
    monkeypatch.delattr(profiling, "spans")
    result, calls = _small_run(monkeypatch, tmp_path, True)
    assert calls == {"slices": 2, "spans": 1}
    assert not NEW & set(result["metrics"])
