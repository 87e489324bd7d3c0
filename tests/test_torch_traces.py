"""The early-stopping traces on a task axis
(`meta/early_stopping.make_batched_early_stopping_trace_fn`) and the
evaluator that runs them (`meta/uho_eval.EarlyStoppingEvaluator`).

- The batched trace of 3 tasks, augmentation and dropout off, against
  `jax.vmap` of the JAX package's trace with the same batch indices
  injected: within 1e-3 per step (a hard IoU may flip a pixel whose
  probability ties 0.5 within float32 rounding).
- The batched trace with augmentation, final dropout and drop-connect on
  (EfficientLab-b0 at 64^2, lr 5e-4: its float32 norms amplify rounding
  at 32^2) against three one-task traces on the same generators: within
  1e-5, in-loop and with the batches precomputed.
- `evaluate_with_early_stopping` in chunks on a task axis against the
  chained traces: the same (steps, IoU).
- The two faults the reference does not have: a mesh drops `chain_chunk`
  (`mliis_tpu/meta/uho_eval.py:54`), and the k-shot curves' evaluators
  trace one task a chunk (`mliis_tpu/meta/kshot.py:69-72`).
The world of 2 against the world of 1 is in tests/test_torch_parallel.py,
whose spawned worlds run it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta import early_stopping as jes
from mliis_tpu.meta import episodes as jep
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.meta import early_stopping as tes
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import kshot as tks
from mliis_tpu_torch.meta import uho_eval as tue
from mliis_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_early_stopping_uho import tiny  # noqa: F401
from tests.test_torch_task_axis import LAB_LR, LAB_SIZE, _generators, _lab

T = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module, as tests/test_torch_task_axis.py
    keeps its EfficientLab steps."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _split(store, rows):
    """Each row's support (even examples) and val (odd) sets, stacked."""
    sup, val = [0, 2, 4, 6, 8], [1, 3, 5, 7, 9]
    return tuple(np.stack([a[r][part] for r in rows])
                 for part in (sup, val) for a in (store.images, store.masks))


def test_batched_trace_matches_jax_vmapped_trace(tiny):  # noqa: F811
    """3 tasks x 8 steps at batch 4 on 5-shot support sets (TinySeg, lr
    0.05, bce_dice + l2), the val mIoU after each step: the batched trace
    within 1e-3 abs per step of the JAX trace under `jax.vmap`."""
    jmodel, jstate, tmodel, tstate, store = tiny
    s_img, s_msk, v_img, v_msk = _split(store, [0, 1, 2])
    keys = jax.random.split(jax.random.PRNGKey(11), T)
    jtrace_fn = jes.make_early_stopping_trace_fn(
        jmodel, jil.LossConfig(), jil.OptimizerConfig("sgd"), max_steps=8,
        inner_batch_size=4, augment=False, support_size=5, val_size=5)
    jtraces = jax.jit(jax.vmap(jtrace_fn, in_axes=(None, 0, 0, 0, 0, 0,
                                                   None, None, None)))(
        jstate, *(jnp.asarray(a) for a in (s_img, s_msk, v_img, v_msk)),
        keys, jnp.float32(0.05), jnp.float32(0.0), None)
    idx = np.stack([np.array(jep.batch_indices(jax.random.split(k)[0], 5, 4,
                                               8, False)) for k in keys])
    ttrace_fn = tes.make_batched_early_stopping_trace_fn(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"), augment=False)
    ttraces = ttrace_fn(til.stack_states([tstate] * T),
                        *(torch.from_numpy(a) for a in (s_img, s_msk, v_img,
                                                        v_msk)),
                        torch.from_numpy(idx), _generators(0), 0.05, 0.0,
                        None)
    assert ttraces.shape == (T, 8)
    np.testing.assert_allclose(ttraces.numpy(), np.asarray(jtraces),
                               atol=1e-3, rtol=0)
    assert float(ttraces.max() - ttraces.min()) > 0  # the probes moved


@pytest.mark.parametrize("precompute", [False, True],
                         ids=["in_loop", "precomputed"])
def test_batched_trace_equals_one_task_traces(precompute):
    """EfficientLab-b0 at 64^2 with final dropout 0.5 and drop-connect
    0.2, 3 tasks x 3 augmented steps (rate 0.9) at batch 4, lr 5e-4: each
    row of the batched trace within 1e-5 of the one-task trace of its
    task on the same generator."""
    model = _lab()
    store = make_synthetic_store(num_tasks=3, examples_per_task=10,
                                 image_size=LAB_SIZE, seed=3)
    parts = [torch.from_numpy(a) for a in _split(store, [0, 1, 2])]
    idx = torch.randint(0, 5, (T, 3, 4),
                        generator=torch.Generator().manual_seed(4))
    opt = til.OptimizerConfig("sgd")
    state = til.init_model_state(model, opt)
    kw = dict(precompute_augment=precompute)
    traces = tes.make_batched_early_stopping_trace_fn(
        model, til.LossConfig(), opt, **kw)(
        til.stack_states([state] * T), *parts, idx, _generators(70),
        LAB_LR, 0.5, 0.9)
    one = tes.make_early_stopping_trace_fn(model, til.LossConfig(), opt,
                                           **kw)
    for t, gen in enumerate(_generators(70)):
        ref = one(state, *(p[t] for p in parts), idx[t], gen, LAB_LR, 0.5,
                  0.9)
        np.testing.assert_allclose(traces[t].numpy(), ref.numpy(),
                                   atol=1e-5, rtol=0)
    assert float(traces.max() - traces.min()) > 0


def _evaluator(tiny, **kw):  # noqa: F811
    _, _, tmodel, _, store = tiny
    return tue.EarlyStoppingEvaluator(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"),
        TaskStore(store.images, store.masks, store.counts, store.names),
        num_shots=5, test_shots=5, patience=3, device="cpu", **kw)


@pytest.mark.parametrize("median", [False, True],
                         ids=["traces", "median_re_evaluation"])
def test_chunked_evaluation_equals_chained(tiny, median):  # noqa: F811
    """`evaluate_with_early_stopping` over the 3 tasks with augmentation
    and dropout on, in chunks of 2 on a task axis (the last one ragged)
    and with `chain_chunk`, from the same seed: the same best steps and
    IoUs (within 1e-6), with the median-step re-evaluation and without."""
    tstate = tiny[3]
    runs = []
    for chain in (False, True):
        ev = _evaluator(tiny, task_chunk_size=2, chain_chunk=chain)
        runs.append(ev.evaluate_with_early_stopping(
            tstate, torch.Generator().manual_seed(3), min_steps=1,
            max_steps=6, inner_batch_size=4, lr=0.05, drop_rate=0.3,
            aug_rate=0.9, eval_all_tasks=True,
            eval_tasks_with_median_early_stopping_iterations=median))
    (names, steps, ious), (c_names, c_steps, c_ious) = runs
    assert names == c_names and steps == c_steps
    np.testing.assert_allclose(ious, c_ious, atol=1e-6)
    assert len(set(steps)) > 1 or len(set(ious)) > 1


def test_chunks_make_one_trace_launch_a_step(tiny, monkeypatch):  # noqa: F811
    """5 list positions (3 tasks, repeated) in chunks of 2: the batched
    trace runs on chunks of 2, 2 and 1 (the last not padded);
    `chain_chunk` runs the one-task trace 5 times."""
    tstate = tiny[3]
    calls = []
    for chain in (False, True):
        ev = _evaluator(tiny, task_chunk_size=2, chain_chunk=chain)
        for name in ("_trace", "_batched_trace"):
            real = getattr(ev, name)

            def spy(*a, _real=real, _name=name):
                calls.append((chain, _name, len(a[6]) if _name ==
                              "_batched_trace" else 1))
                return _real(*a)
            monkeypatch.setattr(ev, name, spy)
        ev.evaluate_with_early_stopping(
            tstate, torch.Generator().manual_seed(1), min_steps=1,
            max_steps=2, inner_batch_size=4, lr=0.05,
            task_indices=[0, 1, 2, 0, 1])
    assert calls == [(False, "_batched_trace", 2)] * 2 + [
        (False, "_batched_trace", 1)] + [(True, "_trace", 1)] * 5


def test_mesh_drops_chain_chunk(tiny, tmp_path, monkeypatch):  # noqa: F811
    """Under a mesh the evaluator drops `chain_chunk`, as the JAX
    package's does (`mliis_tpu/meta/uho_eval.py:54`): its traces and its
    median-step re-evaluation run on the task axis. Before the repair the
    port kept the flag and chained both."""
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert _evaluator(tiny, chain_chunk=True).chain_chunk
    with mesh_lib.world(1, "cpu", str(tmp_path)) as dev:
        ev = _evaluator(tiny, chain_chunk=True,
                        mesh=mesh_lib.make_task_mesh(1, dev))
        assert not ev.chain_chunk
        ev.evaluate_with_early_stopping(
            tiny[3], torch.Generator().manual_seed(2), min_steps=1,
            max_steps=2, inner_batch_size=4, lr=0.05, eval_all_tasks=True,
            eval_tasks_with_median_early_stopping_iterations=True)
    assert [cfg.chain_chunk for cfg in ev._gecko_cache] == [False]


def test_kshot_early_stopping_traces_one_task_a_chunk(tiny):  # noqa: F811
    """`EvaluatorCache.early_stopping` builds its evaluators with
    `task_chunk_size=1`, as the JAX package's does
    (`mliis_tpu/meta/kshot.py:69-72`); the port passed nothing and got
    the default of 4."""
    _, _, tmodel, _, store = tiny
    cache = tks.EvaluatorCache(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"),
        TaskStore(store.images, store.masks, store.counts, store.names),
        device="cpu")
    assert cache.early_stopping(8, 2).task_chunk_size == 1
