"""The run's exports against the JAX package: the evaluator's fine-tuned
checkpoints, the serving artifact, the profiler trace and the prediction
overlays, and the meta-training CLI with every flag that writes them.

`cli_run` drives `run_metasegnet.main` once on the CPU at 32^2 with
`--spatial_pyramid_pooling --skip_decoding` and the four export flags;
the tests below read what it wrote.
"""
import glob
import gzip
import json
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta.inner_loop import init_opt_state as jinit_opt
from mliis_tpu.meta.inner_loop import ModelState as JModelState
from mliis_tpu.meta.inner_loop import OptimizerConfig as JOptimizerConfig
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu.utils import checkpoint as jckpt
from mliis_tpu.utils import viz as jviz
from mliis_tpu_torch.cli import args as targs
from mliis_tpu_torch.cli import run_metasegnet as trun
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import evaluate as tev
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta.episodes import onehot_mask
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops.metrics import batched_hard_iou
from mliis_tpu_torch.utils import checkpoint as tckpt
from mliis_tpu_torch.utils import export as texport
from mliis_tpu_torch.utils import profiling
from mliis_tpu_torch.utils import viz as tviz
from tests.test_torch_decoders import nested
from tests.torch_tiny_model import TorchTinySeg

SIZE = 32
CLI = ("--synthetic --synthetic_tasks 2 --image_size 32 --rsd 2 --sgd "
       "--loss_name bce_dice --inner-batch 4 --train-shots 6 --inner-iters 1 "
       "--meta-iters 1 --meta-batch 1 --eval-interval 2 --eval-samples 1 "
       "--eval-batch 4 --eval-iters 1 --transductive "
       "--spatial_pyramid_pooling --skip_decoding "
       "--save_fine_tuned_checkpoints --save_fine_tuned_checkpoints_train "
       "--seed 1")


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One CPU run of the CLI with every ported export flag; returns
    (args, final state, output directory)."""
    out = tmp_path_factory.mktemp("cli")
    argv = shlex.split(CLI) + [
        "--checkpoint", str(out / "ckpt"),
        "--save_fine_tuned_checkpoints_dir", str(out / "fine_tuned"),
        "--profile_dir", str(out / "profile"),
        "--export_serving_artifact", str(out / "serving.pt2")]
    state = trun.main(argv, device="cpu")
    return targs.argument_parser().parse_args(argv), state, out


def _tiny(seed=0):
    """TorchTinySeg with weights drawn from `seed`."""
    model = TorchTinySeg()
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    return model


def _port_model(args, state):
    model = EfficientLab(**targs.model_kwargs(args))
    til.load_state(model, state)
    return model


def test_cli_writes_every_export(cli_run):
    """The results, one fine-tuned checkpoint a (task, sample) at
    `<dir>/<task>/<sample>/model.ckpt-<eval_iters>.npz` (1 sampled train
    task and the 1 test task), the artifact and one trace."""
    args, _, out = cli_run
    assert os.path.exists(out / "ckpt" / "meta-test_results.json")
    found = sorted(glob.glob(str(out / "fine_tuned" / "*" / "*" / "*.npz")))
    assert len(found) == 2
    for path in found:
        assert os.path.basename(path) == "model.ckpt-1.npz"
        assert os.path.basename(os.path.dirname(path)) == "0"
    assert {os.path.basename(os.path.dirname(os.path.dirname(p)))
            for p in found} == {"synthetic_rect_0000", "synthetic_ellipse_0001"}
    assert os.path.exists(out / "serving.pt2")
    assert len(glob.glob(str(out / "profile" / "*.pt.trace.json.gz"))) == 1


def test_fine_tuned_checkpoint_reads_in_jax(cli_run):
    """A fine-tuned checkpoint of the ASPP + skip-decoding model, read by
    the JAX package's `restore_checkpoint` (strict: every path present,
    every shape right), holds the port's arrays bit for bit, and JAX's
    eval forward of it gives the port's probabilities within 1e-5."""
    args, state, out = cli_run
    path = glob.glob(str(out / "fine_tuned" / "synthetic_rect_0000" / "0"
                         / "*.npz"))[0]
    tuned, meta = tckpt.restore_checkpoint(path, state)
    assert meta["step"] == args.eval_iters
    assert any(not torch.equal(tuned.params[k], v)
               for k, v in state.params.items())
    model = _port_model(args, tuned)
    flat = tckpt.params_to_jax(model)
    template_model = EfficientLab(**targs.model_kwargs(args))
    template_model.reset_parameters(torch.Generator().manual_seed(9))
    template = tckpt.params_to_jax(template_model)
    params = nested(template, "params/")
    jtemplate = JModelState(params, nested(template, "batch_stats/"),
                            jinit_opt(params, JOptimizerConfig("sgd")))
    jstate, _ = jckpt.restore_checkpoint(path, jtemplate)
    restored = jckpt.flatten_tree(jstate.params, "params/")
    restored.update(jckpt.flatten_tree(jstate.batch_stats, "batch_stats/"))
    assert sorted(restored) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    images = np.random.default_rng(3).uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = JaxEfficientLab(**targs.model_kwargs(args))
    (_, jprob), _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, mutable=["batch_stats"]))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(images))
    with torch.no_grad():
        _, tprob = model(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("batch", [1, 5])
def test_serving_artifact_round_trips(cli_run, batch):
    """The CLI's artifact, loaded with `torch.export.load`, gives the
    final model's eval-mode probabilities at batch 1 and 5 (its batch is
    dynamic), within 1e-6."""
    args, state, out = cli_run
    program = texport.load_serving_artifact(str(out / "serving.pt2"))
    images = torch.rand((batch, SIZE, SIZE, 3),
                        generator=torch.Generator().manual_seed(batch)) * 255
    with torch.no_grad():
        ref = _port_model(args, state)(images, train=False)[1]
        got = program.module()(images)
    assert got.shape == (batch, SIZE, SIZE, 2)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_serving_artifact_fixed_batch(tmp_path):
    """`batch_size` pins the batch: the program takes that batch and
    refuses another."""
    model = _tiny()
    state = til.init_model_state(model, til.OptimizerConfig())
    path = texport.save_serving_artifact(str(tmp_path / "a.pt2"), model,
                                         state, 16, batch_size=3)
    program = texport.load_serving_artifact(path).module()
    images = torch.rand(3, 16, 16, 3) * 255
    with torch.no_grad():
        torch.testing.assert_close(program(images),
                                   model(images, train=False)[1])
    with pytest.raises(AssertionError, match="size"):
        program(torch.rand(2, 16, 16, 3))


def test_cli_trace_holds_the_phases(cli_run):
    """The CLI's gzipped trace parses as JSON and holds the PhaseTimer
    phases as `record_function` ranges."""
    _, _, out = cli_run
    (path,) = glob.glob(str(out / "profile" / "*.pt.trace.json.gz"))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"meta_step", "eval_train", "eval_test"} <= ranges


def test_trace_writes_a_chrome_trace(tmp_path):
    """`trace` on the CPU: one parseable Chrome trace in the directory,
    with a PhaseTimer phase and the ops inside it."""
    timer = profiling.PhaseTimer()
    with profiling.trace(str(tmp_path / "p"), device="cpu") as path:
        with timer.phase("work"):
            torch.ones(8).add_(1)
    assert os.listdir(tmp_path / "p") == [os.path.basename(path)]
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "work" in names and "aten::add_" in names


def test_exported_checkpoint_reproduces_the_reported_iou(tmp_path,
                                                         monkeypatch):
    """The evaluation's export is the scored episode: with the episodes'
    draws injected, each task's fine-tuned checkpoint, loaded into a fresh
    model, predicts that episode's query images with the very IoU the
    evaluation reported."""
    store = make_synthetic_store(num_tasks=3, examples_per_task=10,
                                 image_size=16, seed=0)
    config = tev.EvalConfig(num_shots=5, test_shots=5, inner_batch_size=4,
                            inner_iters=3, augment=False)
    gen = torch.Generator().manual_seed(4)
    draws = [tev.draw_episode(gen, torch.tensor(int(c)), config, 10)
             for c in store.counts]
    queue = list(draws)
    monkeypatch.setattr(tev, "draw_episode", lambda *a: queue.pop(0))
    model = _tiny()
    state = til.init_model_state(model, til.OptimizerConfig())
    evaluator = tev.GeckoEvaluator(model, til.LossConfig(),
                                   til.OptimizerConfig(), config, store,
                                   device="cpu")
    save_dir = str(tmp_path / "ft")
    _, reported = evaluator.evaluate(
        state, torch.Generator().manual_seed(1), lr=0.1, eval_all_tasks=True,
        save_fine_tuned_checkpoints=True,
        save_fine_tuned_checkpoints_dir=save_dir, eval_sample_num=0)
    assert not queue
    fresh = _tiny(1)
    for i, name in enumerate(store.names):
        tuned, _ = tckpt.restore_checkpoint(
            os.path.join(save_dir, name, "0"), state)
        til.load_state(fresh, tuned)
        d = draws[i]
        query = d.shot_idx[d.query_rel]
        images = torch.from_numpy(store.images[i])[query].float()
        onehot = onehot_mask(torch.from_numpy(store.masks[i])[query])
        with torch.no_grad():
            probs = fresh(images, train=False)[1]
        iou = batched_hard_iou((probs > 0.5).float(), onehot)
        assert float(np.nanmean(iou.numpy())) == reported[name]


def test_overlay_equals_the_jax_packages(tmp_path, monkeypatch):
    """`save_query_predictions` writes the JAX package's files, pixel for
    pixel."""
    from PIL import Image
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (2, 24, 24, 3)).astype(np.float32)
    preds = (rng.random((2, 24, 24, 2)) > 0.5).astype(np.float32)
    tviz.save_query_predictions(images, preds, "task", str(tmp_path / "t"))
    jviz.save_query_predictions(images, preds, "task", str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["prediction_task_0.jpeg", "prediction_task_1.jpeg"]
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        ours = np.asarray(Image.open(tmp_path / "t" / name))
        ref = np.asarray(Image.open(tmp_path / "j" / name))
        np.testing.assert_array_equal(ours, ref)


def test_overlays_without_matplotlib_raise(monkeypatch):
    """With SAVE_PREDICTIONS set and no matplotlib, the evaluation stops
    with an ImportError that says why."""
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setenv("SAVE_PREDICTIONS", "1")
    store = make_synthetic_store(num_tasks=1, examples_per_task=10,
                                 image_size=16, seed=0)
    model = _tiny()
    evaluator = tev.GeckoEvaluator(
        model, til.LossConfig(), til.OptimizerConfig(),
        tev.EvalConfig(inner_iters=1, augment=False), store, device="cpu")
    with pytest.raises(ImportError, match="SAVE_PREDICTIONS.*matplotlib"):
        evaluator.evaluate(til.init_model_state(model, til.OptimizerConfig()),
                           torch.Generator(), lr=0.1, eval_all_tasks=True)


def test_fine_tuned_layout_matches_jax(tmp_path):
    """`save_fine_tuned_checkpoint` writes where the JAX package's does."""
    model = _tiny()
    state = til.init_model_state(model, til.OptimizerConfig())
    ours = tckpt.save_fine_tuned_checkpoint(str(tmp_path / "t" / "bus"),
                                            state, step=59, eval_sample_num=1)
    flat = tckpt.params_to_jax(model)
    params = nested(flat, "params/")
    jstate = JModelState(params, nested(flat, "batch_stats/"),
                         jinit_opt(params, JOptimizerConfig("sgd")))
    ref = jckpt.save_fine_tuned_checkpoint(str(tmp_path / "j" / "bus"),
                                           jstate, step=59, eval_sample_num=1)
    assert os.path.relpath(ours, tmp_path / "t") == os.path.relpath(
        ref, tmp_path / "j") == os.path.join("bus", "1", "model.ckpt-59.npz")
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
